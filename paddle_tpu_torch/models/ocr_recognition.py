"""CRNN-CTC OCR recognition (port of
``paddle_tpu/models/ocr_recognition.py``; the reference era's
ocr_recognition model, built from the pieces the reference ships in
layers/nn.py: im2sequence:3080, dynamic_gru, warpctc:3713,
ctc_greedy_decoder:3640, edit_distance).

Topology: stacked conv+BN groups shrink the image height, im2sequence
turns the feature map into a horizontal sequence, a projected
bidirectional GRU encodes it, and a (num_classes+1)-way fc gives
per-column scores for CTC (blank = num_classes), whose loss is the
masked dynamic program of ops/crf_ctc.py.
"""
from .. import layers, nets

__all__ = ["encoder_net", "ctc_train_net", "ctc_infer"]


def encoder_net(images, num_classes, rnn_hidden=64,
                conv_filters=(16, 32), use_bn=True):
    """images: float var [C, H, W] (batch-implicit). Returns per-column
    class scores (lod_level=1, [sum_cols, num_classes + 1])."""
    x = images
    for nf in conv_filters:
        x = nets.img_conv_group(
            x, conv_num_filter=[nf, nf], conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=use_bn,
            pool_size=2, pool_stride=2)
    # one sequence step per feature-map column (full remaining height)
    h = int(x.shape[2])
    cols = layers.im2sequence(x, filter_size=[h, 1], stride=[1, 1])

    fc_fw = layers.fc(input=cols, size=rnn_hidden * 3)
    fc_bw = layers.fc(input=cols, size=rnn_hidden * 3)
    fc_fw.lod_level = fc_bw.lod_level = 1
    gru_fw = layers.dynamic_gru(input=fc_fw, size=rnn_hidden)
    gru_bw = layers.dynamic_gru(input=fc_bw, size=rnn_hidden,
                                is_reverse=True)
    scores = layers.fc(input=[gru_fw, gru_bw], size=num_classes + 1)
    scores.lod_level = 1
    return scores


def ctc_train_net(images, label, num_classes, rnn_hidden=64,
                  conv_filters=(16, 32)):
    """label: int sequence var (lod_level=1). Returns (avg CTC loss,
    greedy-decoded sequences) — pair the decode with
    evaluator.EditDistance/metrics for the reference's error metric."""
    scores = encoder_net(images, num_classes, rnn_hidden, conv_filters)
    loss = layers.warpctc(input=scores, label=label, blank=num_classes)
    decoded = layers.ctc_greedy_decoder(input=scores, blank=num_classes)
    return layers.mean(loss), decoded


def ctc_infer(images, num_classes, rnn_hidden=64, conv_filters=(16, 32)):
    scores = encoder_net(images, num_classes, rnn_hidden, conv_filters)
    return layers.ctc_greedy_decoder(input=scores, blank=num_classes)
