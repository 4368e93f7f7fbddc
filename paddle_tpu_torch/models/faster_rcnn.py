"""Faster-RCNN detection model on the RPN op family (port of
``paddle_tpu/models/faster_rcnn.py``).

Paddle ships the op set (rpn_target_assign, generate_proposals,
generate_proposal_labels, anchor_generator, roi_pool — reference
paddle/fluid/operators/detection/) without a bundled model; this wires
them into the canonical two-stage detector: backbone → RPN head
(objectness + deltas) → RPN loss, proposals → sampled RoIs → RoI-pooled
RCNN head → cls + bbox losses. Every stage is fixed-shape.
"""
from .. import layers
from ..layers import detection as det
from ..param_attr import ParamAttr
from .. import initializer as init_mod

__all__ = ["FasterRCNNConfig", "build_faster_rcnn"]


class FasterRCNNConfig:
    def __init__(self, class_num=21, anchor_sizes=(32.0, 64.0, 128.0),
                 aspect_ratios=(0.5, 1.0, 2.0), stride=(16.0, 16.0),
                 rpn_channels=64, backbone_channels=(16, 32),
                 rpn_batch_size=64, rpn_fg_fraction=0.25,
                 pre_nms_top_n=512, post_nms_top_n=64,
                 roi_batch_size=32, roi_fg_fraction=0.25,
                 pooled_size=7, head_dim=128):
        self.class_num = class_num
        self.anchor_sizes = list(anchor_sizes)
        self.aspect_ratios = list(aspect_ratios)
        self.stride = list(stride)
        self.rpn_channels = rpn_channels
        self.backbone_channels = list(backbone_channels)
        self.rpn_batch_size = rpn_batch_size
        self.rpn_fg_fraction = rpn_fg_fraction
        self.pre_nms_top_n = pre_nms_top_n
        self.post_nms_top_n = post_nms_top_n
        self.roi_batch_size = roi_batch_size
        self.roi_fg_fraction = roi_fg_fraction
        self.pooled_size = pooled_size
        self.head_dim = head_dim


def _backbone(image, cfg):
    """Tiny strided conv backbone standing in for ResNet (swap in
    models.resnet for the full thing); overall stride must match
    cfg.stride."""
    h = image
    for i, c in enumerate(cfg.backbone_channels):
        h = layers.conv2d(h, num_filters=c, filter_size=3, stride=2,
                          padding=1, act="relu",
                          param_attr=ParamAttr(name=f"bb{i}.w"))
    # two more stride-2 pools to reach stride 16 with 2 convs
    h = layers.pool2d(h, pool_size=2, pool_type="max", pool_stride=2)
    h = layers.pool2d(h, pool_size=2, pool_type="max", pool_stride=2)
    return h


def build_faster_rcnn(image, gt_box, gt_label, im_info, cfg=None,
                      is_train=True):
    """image [B,3,H,W]; gt_box lod[G,4]; gt_label lod[G,1];
    im_info [B,3]. Returns (total_loss, rois, cls_score) when training,
    (rois, cls_prob, bbox_pred) otherwise."""
    cfg = cfg or FasterRCNNConfig()
    a = len(cfg.anchor_sizes) * len(cfg.aspect_ratios)

    feat = _backbone(image, cfg)
    anchors, anchor_var = det.anchor_generator(
        feat, anchor_sizes=cfg.anchor_sizes,
        aspect_ratios=cfg.aspect_ratios, stride=cfg.stride)

    rpn = layers.conv2d(feat, num_filters=cfg.rpn_channels, filter_size=3,
                        padding=1, act="relu",
                        param_attr=ParamAttr(name="rpn.conv"))
    rpn_score = layers.conv2d(rpn, num_filters=a, filter_size=1,
                              param_attr=ParamAttr(name="rpn.score"))
    rpn_delta = layers.conv2d(rpn, num_filters=4 * a, filter_size=1,
                              param_attr=ParamAttr(name="rpn.delta"))

    rois, roi_probs = det.generate_proposals(
        rpn_score, rpn_delta, im_info, anchors, anchor_var,
        pre_nms_top_n=cfg.pre_nms_top_n,
        post_nms_top_n=cfg.post_nms_top_n)

    if not is_train:
        pooled = layers.roi_pool(feat, rois,
                                 pooled_height=cfg.pooled_size,
                                 pooled_width=cfg.pooled_size,
                                 spatial_scale=1.0 / cfg.stride[0])
        head = layers.fc(pooled, size=cfg.head_dim, act="relu",
                         param_attr=ParamAttr(name="head.fc"))
        cls_score = layers.fc(head, size=cfg.class_num,
                              param_attr=ParamAttr(name="head.cls"))
        bbox_pred = layers.fc(head, size=4 * cfg.class_num,
                              param_attr=ParamAttr(name="head.bbox"))
        return rois, layers.softmax(cls_score), bbox_pred

    # ---- RPN loss -----------------------------------------------------
    # flatten head outputs to per-anchor rows matching the anchor layout
    b = image.shape[0]
    m = -1  # H*W*A, static once shapes are known
    score_flat = layers.reshape(
        layers.transpose(rpn_score, perm=[0, 2, 3, 1]), [0, -1, 1])
    delta_flat = layers.reshape(
        layers.transpose(rpn_delta, perm=[0, 2, 3, 1]), [0, -1, 4])
    anchors_flat = layers.reshape(anchors, [-1, 4])
    sp, lp, st, lt = det.rpn_target_assign(
        delta_flat, score_flat, anchors_flat, anchor_var, gt_box,
        rpn_batch_size_per_im=cfg.rpn_batch_size,
        fg_fraction=cfg.rpn_fg_fraction)
    rpn_cls_loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(
            sp, layers.cast(st, "float32")))
    rpn_reg_loss = layers.mean(layers.smooth_l1(lp, lt))

    # ---- RCNN head ----------------------------------------------------
    s_rois, s_labels, s_tgt, s_win, s_wout = det.generate_proposal_labels(
        rois, gt_label, gt_box, im_scales=_im_scales(im_info),
        batch_size_per_im=cfg.roi_batch_size,
        fg_fraction=cfg.roi_fg_fraction, fg_thresh=0.5,
        bg_thresh_hi=0.5, bg_thresh_lo=0.0, class_nums=cfg.class_num)
    pooled = layers.roi_pool(feat, s_rois,
                             pooled_height=cfg.pooled_size,
                             pooled_width=cfg.pooled_size,
                             spatial_scale=1.0 / cfg.stride[0])
    head = layers.fc(pooled, size=cfg.head_dim, act="relu",
                     param_attr=ParamAttr(name="head.fc"))
    cls_score = layers.fc(head, size=cfg.class_num,
                          param_attr=ParamAttr(name="head.cls"))
    bbox_pred = layers.fc(head, size=4 * cfg.class_num,
                          param_attr=ParamAttr(name="head.bbox"))

    labels_flat = layers.reshape(s_labels, [-1, 1])
    # padded RoI slots carry label -1 — excluded via ignore_index
    cls_loss = layers.mean(layers.softmax_with_cross_entropy(
        cls_score, layers.cast(labels_flat, "int64"), ignore_index=-1))
    tgt_flat = layers.reshape(s_tgt, [-1, 4 * cfg.class_num])
    win_flat = layers.reshape(s_win, [-1, 4 * cfg.class_num])
    wout_flat = layers.reshape(s_wout, [-1, 4 * cfg.class_num])
    reg_loss = layers.mean(layers.smooth_l1(
        bbox_pred, tgt_flat, inside_weight=win_flat,
        outside_weight=wout_flat))

    total = layers.sums([rpn_cls_loss, rpn_reg_loss, cls_loss, reg_loss])
    return total, s_rois, cls_score


def _im_scales(im_info):
    """im_info rows are (h, w, scale) — slice out the scale column."""
    return layers.slice(im_info, axes=[1], starts=[2], ends=[3])
