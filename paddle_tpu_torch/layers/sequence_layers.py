"""Sequence layers (port of ``paddle_tpu/layers/sequence_layers.py``):
``sequence_mask`` over a dense [b] lengths tensor. The other sequence
layers need ``SequenceBatch`` and the sequence ops of ROADMAP.md item
'Remaining op families and the zoo'."""
from ..layer_helper import LayerHelper
from ..waiting import REST, module_getattr

__all__ = ["sequence_mask"]

WAITING = dict.fromkeys((
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "gru_unit",
    "lstm_unit", "sequence_pool", "sequence_softmax", "sequence_conv",
    "sequence_expand", "sequence_first_step", "sequence_last_step",
    "sequence_reshape", "sequence_pad", "sequence_unpad",
    "sequence_enumerate", "sequence_concat", "sequence_slice",
    "sequence_erase", "lod_reset", "edit_distance"), REST)
__getattr__ = module_getattr(__name__, WAITING)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(
        dtype, shape=[x.shape[0], maxlen if maxlen else -1],
        stop_gradient=True)
    helper.append_op(type="sequence_mask", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"maxlen": maxlen if maxlen else -1,
                            "out_dtype": dtype})
    return out
