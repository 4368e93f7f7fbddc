"""AMP dtype policy — the op sets that define mixed precision (a copy of
``paddle_tpu/core/amp_policy.py``, which is pure data).

``transpiler/amp.py`` sets ``program._amp`` to ``"O1"`` or ``"O2"``;
``core/lowering.py`` consults these sets as it runs each op:

* ``AMP_MATMUL_OPS`` compute in bf16 under either level. Under O1 their
  bf16 outputs are cast back to f32; under O2 they stay bf16.
* ``AMP_BF16_FLOW_OPS`` take and give bf16 activations under O2 (a
  mixed f32 + bf16 input list computes in f32, and the output is written
  back as bf16). Every op in neither set gets its bf16 inputs upcast to
  f32 under O2, so losses, softmax and optimizer math stay wide.
* ``AMP_SELF_MANAGED_DTYPE_OPS`` are flow ops whose rules set their
  output dtypes themselves (batch_norm: bf16 Y, f32 statistics) and are
  exempt from that write-back.
"""

__all__ = ["AMP_MATMUL_OPS", "AMP_BF16_FLOW_OPS",
           "AMP_SELF_MANAGED_DTYPE_OPS"]

AMP_MATMUL_OPS = frozenset([
    "mul", "matmul", "conv2d", "conv3d", "conv2d_transpose", "fc",
    "multihead_attention", "moe_ffn", "sequence_conv", "depthwise_conv2d",
    # fused ops: their internals keep f32 where it matters (rms
    # accumulation, attention softmax, the chunked log-sum-exp) while
    # the products run in bf16
    "llama_decoder_stack", "llama_generate", "fused_head_cross_entropy",
    "llama_stack_1f1b_loss",
])

AMP_BF16_FLOW_OPS = frozenset([
    "batch_norm", "pool2d", "pool3d", "relu", "relu6", "leaky_relu",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_max", "elementwise_min", "dropout", "transpose",
    "transpose2", "reshape", "reshape2", "flatten", "flatten2",
    "concat", "split", "pad", "pad2d", "squeeze", "squeeze2",
    "unsqueeze", "unsqueeze2", "scale", "fused_elementwise",
])

AMP_SELF_MANAGED_DTYPE_OPS = frozenset(["batch_norm"])
