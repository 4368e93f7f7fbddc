"""HuggingFace Llama checkpoint import (port of
``paddle_tpu/models/llama_import.py``).

Loads a HF ``LlamaForCausalLM`` state dict into the scope layout of
``build_llama(shard_pp=True)`` / ``build_llama_generator``: the
layer-stacked ``{name}.wq`` [L, d, H*hd] tensors (HF stores each
layer's ``*_proj.weight`` as [out, in]; they are transposed and
stacked). Nothing is downloaded: the caller hands over the state dict.

The numerical conventions are HF's (held by
tests/test_torch_llama_import.py against transformers): neox half-split
rope with theta = rope_base, float32-accumulated RMSNorm, SwiGLU, an
untied lm head (a tied one is read from the embedding).
"""
import numpy as np
import torch

__all__ = ["load_hf_llama_state"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _f32(t):
    """A state-dict entry (tensor or array) as a float32 CPU tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float()
    return torch.as_tensor(np.asarray(t, dtype=np.float32))


def load_hf_llama_state(state_dict, cfg, scope=None, name="blocks",
                        emb_name="tok_emb", final_norm_name="final_norm",
                        head_name="lm_head", dtype=None):
    """Write a HF Llama ``state_dict`` into ``scope`` under the stacked
    names ``build_llama(shard_pp=True)`` and the generator use, as host
    tensors the executor stages to its device at its first run.
    ``cfg``: LlamaConfig (shapes are validated against it). ``dtype``:
    the tensors' dtype (default ``cfg.dtype``)."""
    from ..core.executor import global_scope
    scope = scope or global_scope()
    dt = _DTYPES[dtype or cfg.dtype]
    L = cfg.n_layers

    def put(n, t, shape):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{n}: expected {shape}, got "
                             f"{tuple(t.shape)}")
        scope.set(n, t.to(dt).contiguous())

    d, hd = cfg.dim, cfg.dim // cfg.n_heads

    def layer(i, suffix):
        return _f32(state_dict[f"model.layers.{i}.{suffix}"])

    stack = {
        "wq": ("self_attn.q_proj.weight", (L, d, cfg.n_heads * hd)),
        "wk": ("self_attn.k_proj.weight", (L, d, cfg.n_kv_heads * hd)),
        "wv": ("self_attn.v_proj.weight", (L, d, cfg.n_kv_heads * hd)),
        "wo": ("self_attn.o_proj.weight", (L, cfg.n_heads * hd, d)),
        "w_gate": ("mlp.gate_proj.weight", (L, d, cfg.ffn_hidden)),
        "w_up": ("mlp.up_proj.weight", (L, d, cfg.ffn_hidden)),
        "w_down": ("mlp.down_proj.weight", (L, cfg.ffn_hidden, d)),
    }
    for ours, (theirs, want) in stack.items():
        # HF stores [out, in]; the port's products take [in, out]
        put(f"{name}.{ours}",
            torch.stack([layer(i, theirs).T for i in range(L)]), want)
    put(f"{name}.attn_norm",
        torch.stack([layer(i, "input_layernorm.weight")
                     for i in range(L)]), (L, d))
    put(f"{name}.mlp_norm",
        torch.stack([layer(i, "post_attention_layernorm.weight")
                     for i in range(L)]), (L, d))
    put(emb_name, _f32(state_dict["model.embed_tokens.weight"]),
        (cfg.vocab_size, d))
    put(final_norm_name, _f32(state_dict["model.norm.weight"]), (d,))
    head = state_dict.get("lm_head.weight",
                          state_dict["model.embed_tokens.weight"])
    put(head_name, _f32(head).T, (d, cfg.vocab_size))
