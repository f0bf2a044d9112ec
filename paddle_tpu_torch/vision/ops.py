"""Detection ops, PyTorch port.

Counterpart of `paddle_tpu/vision/ops.py`, keeping its split (reference
:1-10): the dense, differentiable ops are torch on the input's device
(`box_iou`, `roi_align`, `roi_pool`, `psroi_pool`, `box_coder`,
`yolo_box`, `deform_conv2d`, `yolo_loss`); the sequential post-processing
runs on host numpy, as the reference's does (`nms`, `matrix_nms`,
`generate_proposals`, `distribute_fpn_proposals`, `prior_box`,
`read_file`, `decode_jpeg`), and returns tensors on the input's device
(the CPU for numpy input).

Semantics kept from the reference, not torchvision's:

- `roi_align` samples with the reference's `_bilinear_sample` (:98-116):
  corners clipped into the map, a sample counted only where -1 < y < H
  and -1 < x < W; ``sampling_ratio <= 0`` means a fixed 2 samples a bin
  side (:130); ``aligned`` shifts boxes by half a pixel, and without it
  a box is at least 1 pixel a side.
- `roi_pool` rounds the scaled box, takes bin edges by floor and ceil,
  and gives 0 for an empty bin (:162-200).
- `nms` orders by ``np.argsort(-scores)``, so ties break as the
  reference's do.

A division by a Python number divides by a tensor holding it (`_div`):
on CUDA, PyTorch divides by a number as a multiplication by its
reciprocal, which can differ from the division by an ulp and move a bin
edge across an integer; so the card computes every sample coordinate and
bin edge as the CPU and the reference do.

Where the reference loops over RoIs in Python (:151, :172-200, :215-240),
the port computes all RoIs of an image at once: `roi_align` as one
bilinear gather of every sample point, `roi_pool` as masked maxima over
the bins' columns and then rows (a maximum over a rectangle is the maximum
of its columns' maxima), `psroi_pool` as two contractions with the bins'
row and column masks. `deform_conv2d` is one bilinear gather over the
[N, K, Ho, Wo] sample points and a grouped contraction with the weight
(`torch.matmul`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..nn import initializer as I
from .models._common import device_and_generator

__all__ = ["nms", "roi_align", "roi_pool", "psroi_pool", "box_coder",
           "yolo_box", "prior_box", "distribute_fpn_proposals", "box_iou",
           "RoIAlign", "RoIPool", "deform_conv2d", "DeformConv2D",
           "PSRoIPool", "matrix_nms", "generate_proposals", "read_file",
           "decode_jpeg", "yolo_loss"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def _tensor(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _div(a, n):
    """a / n, IEEE-rounded on every device (see the module docstring)."""
    return a / torch.tensor(n, dtype=a.dtype, device=a.device)


def box_iou(boxes1, boxes2):
    """Pairwise IoU of [N, 4] and [M, 4] xyxy boxes -> [N, M]."""
    a, b = boxes1, boxes2
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-10)


def _nms_single(boxes, scores, iou_threshold, top_k=None):
    order = np.argsort(-scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if top_k is not None and len(keep) >= top_k:
            break
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        a_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        a_r = (boxes[rest, 2] - boxes[rest, 0]) * \
            (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / (a_i + a_r - inter + 1e-10)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy (optionally category-aware) hard NMS on the host; returns the
    kept indices (int64)."""
    b = _np(boxes)
    s = _np(scores) if scores is not None else \
        np.arange(len(b), 0, -1, dtype=np.float32)
    if category_idxs is None:
        keep = _nms_single(b, s, iou_threshold, top_k)
    else:
        cats = _np(category_idxs)
        kept = []
        for c in (categories if categories is not None
                  else np.unique(cats)):
            c_val = getattr(c, "item", lambda: c)()
            idx = np.nonzero(cats == c_val)[0]
            if idx.size == 0:
                continue
            k = _nms_single(b[idx], s[idx], iou_threshold)
            kept.append(idx[k])
        keep = np.concatenate(kept) if kept else np.array([], np.int64)
        keep = keep[np.argsort(-s[keep], kind="stable")]
        if top_k is not None:
            keep = keep[:top_k]
    return _tensor(keep.astype(np.int64), _device(boxes))


def _bilinear_sample(table, base, y, x, h, w):
    """The reference's `_bilinear_sample` as one gather: `table` [M, C]
    holds maps of h x w rows (channels last), `base` the first row of each
    sample's map (broadcast with y and x); returns [*y.shape, C]."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1

    def get(yy, xx):
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        return table[base + yc * w + xc]

    out = (get(y0, x0) * (wy0 * wx0)[..., None]
           + get(y0, x1) * (wy0 * wx1)[..., None]
           + get(y1, x0) * (wy1 * wx0)[..., None]
           + get(y1, x1) * (wy1 * wx1)[..., None])
    # zero outside the feature map (the reference samples in range only)
    valid = (y > -1) & (y < h) & (x > -1) & (x < w)
    return out * valid[..., None]


def _rois(boxes_num):
    """Per RoI, the index of its image (boxes_num counts each image's
    RoIs, in order)."""
    num = _np(boxes_num).astype(np.int64)
    return np.repeat(np.arange(len(num)), num)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """Differentiable RoIAlign. x: [N, C, H, W]; boxes: [R, 4] xyxy;
    boxes_num: [N] -> [R, C, ph, pw]."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    n, c, h, w = x.shape
    batch_idx = torch.from_numpy(_rois(boxes_num)).to(x.device)
    r = batch_idx.numel()
    if r == 0:
        return x.new_zeros((0, c, ph, pw))
    ratio = sampling_ratio if sampling_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    b = boxes * spatial_scale - offset
    xs0, ys0 = b[:, 0], b[:, 1]
    rw = b[:, 2] - xs0
    rh = b[:, 3] - ys0
    if not aligned:
        rw = rw.clamp(min=1.0)
        rh = rh.clamp(min=1.0)
    bin_h = _div(rh, ph)
    bin_w = _div(rw, pw)
    # sample grid: [ph*ratio, pw*ratio] points a RoI, in bin units
    gy = _div(torch.arange(ph * ratio, device=x.device) + 0.5, ratio)
    gx = _div(torch.arange(pw * ratio, device=x.device) + 0.5, ratio)
    yy = (ys0[:, None] + gy[None] * bin_h[:, None])[:, :, None]
    xx = (xs0[:, None] + gx[None] * bin_w[:, None])[:, None, :]
    yy, xx = torch.broadcast_tensors(yy, xx)        # [R, ph*r, pw*r]
    table = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = (batch_idx * (h * w))[:, None, None]
    samples = _bilinear_sample(table, base, yy, xx, h, w)
    samples = samples.permute(0, 3, 1, 2)           # [R, C, ph*r, pw*r]
    return samples.reshape(r, c, ph, ratio, pw, ratio).mean((3, 5))


def _bin_masks(lo, extent, bins, size, device):
    """[R, bins, size] masks of the pixels in each bin along one axis: bin
    k spans [floor(lo + extent·k/bins), ceil(lo + extent·(k+1)/bins)),
    cut to the map."""
    k = torch.arange(bins, device=device, dtype=lo.dtype)
    start = torch.floor(lo[:, None] + _div(extent[:, None] * k, bins))
    end = torch.ceil(lo[:, None] + _div(extent[:, None] * (k + 1), bins))
    pix = torch.arange(size, device=device)[None, None]
    return ((pix >= start[..., None]) & (pix < end[..., None])
            & (pix >= 0) & (pix < size))


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoIPool: the maximum over each of the box's integer bins."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    n, c, h, w = x.shape
    batch_idx = torch.from_numpy(_rois(boxes_num)).to(x.device)
    if batch_idx.numel() == 0:
        return x.new_zeros((0, c, ph, pw))
    b = torch.round(boxes * spatial_scale)
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    rows = _bin_masks(y0, (y1 - y0 + 1).clamp(min=1.0), ph, h, x.device)
    cols = _bin_masks(x0, (x1 - x0 + 1).clamp(min=1.0), pw, w, x.device)
    feat = x[batch_idx]                             # [R, C, H, W]
    neg = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
    colmax = torch.stack([
        torch.where(cols[:, q, None, None, :], feat, neg).amax(-1)
        for q in range(pw)], -1)                    # [R, C, H, pw]
    out = torch.stack([
        torch.where(rows[:, p, None, :, None], colmax, neg).amax(2)
        for p in range(ph)], 2)                     # [R, C, ph, pw]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): channels split into
    ph·pw groups; bin (i, j) averages its own group over its pixels."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    n, c_total, h, w = x.shape
    if c_total % (ph * pw) != 0:
        raise ValueError("channels must divide output_size^2")
    c_out = c_total // (ph * pw)
    num = _np(boxes_num).astype(np.int64)
    if num.sum() == 0:
        return x.new_zeros((0, c_out, ph, pw))
    b = boxes * spatial_scale
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    rows = _bin_masks(y0, (y1 - y0).clamp(min=0.1), ph, h, x.device)
    cols = _bin_masks(x0, (x1 - x0).clamp(min=0.1), pw, w, x.device)
    count = (rows.sum(-1)[:, :, None] * cols.sum(-1)[:, None, :]) \
        .clamp(min=1)                               # [R, ph, pw]
    rows, cols = rows.to(x.dtype), cols.to(x.dtype)
    groups = x.reshape(n, ph, pw, c_out, h, w)
    outs, start = [], 0
    for img, k in enumerate(num.tolist()):          # an image's RoIs
        sl = slice(start, start + k)
        start += k
        t = torch.einsum("pqchw,rqw->rpqch", groups[img], cols[sl])
        outs.append(torch.einsum("rpqch,rph->rcpq", t, rows[sl]))
    return torch.cat(outs) / count[:, None].to(x.dtype)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode boxes against priors, or decode [N, 4] deltas (SSD / R-CNN
    deltas)."""
    p, t = prior_box, target_box
    if isinstance(prior_box_var, (list, tuple)):
        var = torch.tensor(prior_box_var, dtype=torch.float32,
                           device=p.device)
    elif prior_box_var is None:
        var = torch.ones(4, dtype=torch.float32, device=p.device)
    else:
        var = prior_box_var
    norm = 0.0 if box_normalized else 1.0
    pw = p[:, 2] - p[:, 0] + norm
    ph = p[:, 3] - p[:, 1] + norm
    pcx = p[:, 0] + pw * 0.5
    pcy = p[:, 1] + ph * 0.5
    v = var.reshape(1, 4) if var.ndim == 1 else var
    if code_type == "encode_center_size":
        tw = t[:, 2] - t[:, 0] + norm
        th = t[:, 3] - t[:, 1] + norm
        tcx = t[:, 0] + tw * 0.5
        tcy = t[:, 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], 1)
        return out / v
    d = t * v
    cx = d[:, 0] * pw + pcx
    cy = d[:, 1] * ph + pcy
    bw = torch.exp(d[:, 2]) * pw
    bh = torch.exp(d[:, 3]) * ph
    return torch.stack([cx - bw * 0.5, cy - bh * 0.5,
                        cx + bw * 0.5 - norm, cy + bh * 0.5 - norm], 1)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode a YOLOv3 head's output [N, A·(5+C), H, W] into (boxes
    [N, A·H·W, 4], scores [N, A·H·W, C])."""
    a = torch.tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                     device=x.device)
    na = a.shape[0]
    n, _, h, w = x.shape
    p = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=x.device)
    gy = torch.arange(h, dtype=torch.float32, device=x.device)
    bx = (torch.sigmoid(p[:, :, 0]) * scale_x_y
          - (scale_x_y - 1) / 2 + gx[None, None, None, :]) / w
    by = (torch.sigmoid(p[:, :, 1]) * scale_x_y
          - (scale_x_y - 1) / 2 + gy[None, None, :, None]) / h
    bw = torch.exp(p[:, :, 2]) * a[None, :, 0, None, None] \
        / (downsample_ratio * w)
    bh = torch.exp(p[:, :, 3]) * a[None, :, 1, None, None] \
        / (downsample_ratio * h)
    conf = torch.sigmoid(p[:, :, 4])
    probs = torch.sigmoid(p[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] >= conf_thresh, probs,
                        torch.zeros_like(probs))
    imh = img_size[:, 0].float()[:, None, None, None]
    imw = img_size[:, 1].float()[:, None, None, None]
    x0 = (bx - bw / 2) * imw
    y0 = (by - bh / 2) * imh
    x1 = (bx + bw / 2) * imw
    y1 = (by + bh / 2) * imh
    if clip_bbox:
        x0 = x0.clamp(min=0)
        y0 = y0.clamp(min=0)
        x1 = torch.minimum(x1, imw - 1)
        y1 = torch.minimum(y1, imh - 1)
    boxes = torch.stack([x0, y0, x1, y1], -1).reshape(n, -1, 4)
    scores = torch.movedim(probs, 2, -1).reshape(n, -1, class_num)
    return boxes, scores


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes for one feature map, generated on the host (static
    per shape): (boxes [fh, fw, P, 4], variances [fh, fw, P, 4])."""
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = steps[0] or iw / fw
    step_h = steps[1] or ih / fh

    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)

    boxes = []
    for y in range(fh):
        for x in range(fw):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            for k, ms in enumerate(np.atleast_1d(min_sizes)):
                # min-size square
                boxes.append([cx - ms / 2, cy - ms / 2,
                              cx + ms / 2, cy + ms / 2])
                # extra aspect ratios
                for ar in ars:
                    if abs(ar - 1.0) < 1e-6:
                        continue
                    bw = ms * math.sqrt(ar)
                    bh = ms / math.sqrt(ar)
                    boxes.append([cx - bw / 2, cy - bh / 2,
                                  cx + bw / 2, cy + bh / 2])
                if max_sizes is not None:
                    bs = math.sqrt(ms * np.atleast_1d(max_sizes)[k])
                    boxes.append([cx - bs / 2, cy - bs / 2,
                                  cx + bs / 2, cy + bs / 2])
    out = np.asarray(boxes, np.float32)
    out[:, 0::2] /= iw
    out[:, 1::2] /= ih
    if clip:
        out = np.clip(out, 0.0, 1.0)
    out = out.reshape(fh, fw, -1, 4)
    var = np.broadcast_to(np.asarray(variance, np.float32), out.shape)
    device = _device(input)
    return _tensor(out, device), _tensor(var, device)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Route RoIs to FPN levels by scale, on the host: (the RoIs of each
    level, the index [R, 1] that restores the input order[, the count of
    each level's RoIs])."""
    rois = _np(fpn_rois)
    device = _device(fpn_rois)
    offset = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + offset
    h = rois[:, 3] - rois[:, 1] + offset
    scale = np.sqrt(np.clip(w * h, 0, None))
    level = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    level = np.clip(level, min_level, max_level).astype(np.int64)

    multi_rois = []
    rois_num_per = []
    order = []
    for lv in range(min_level, max_level + 1):
        idx = np.nonzero(level == lv)[0]
        multi_rois.append(_tensor(rois[idx], device))
        rois_num_per.append(_tensor(np.asarray([len(idx)], np.int32),
                                    device))
        order.append(idx)
    restore = np.argsort(np.concatenate(order)) if order else \
        np.array([], np.int64)
    restore_ind = _tensor(restore.astype(np.int64)[:, None], device)
    if rois_num is not None:
        return multi_rois, restore_ind, rois_num_per
    return multi_rois, restore_ind


class RoIAlign(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(nn.Module):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1, or v2 with a `mask` (modulated).
    Offsets are (dy, dx) interleaved per kernel tap and deformable group:
    [N, 2·G·kh·kw, Ho, Wo]; mask [N, G·kh·kw, Ho, Wo]."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    k = kh * kw
    g = deformable_groups
    cpg = cin // g
    dev = x.device

    # base sampling positions per tap and output pixel: [K, Ho, Wo]
    oy = torch.arange(ho, device=dev) * sh - ph
    ox = torch.arange(wo, device=dev) * sw - pw
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw, device=dev) * dw, indexing="ij")
    base_y = ky.reshape(k, 1, 1) + oy[None, :, None]
    base_x = kx.reshape(k, 1, 1) + ox[None, None, :]
    off = offset.reshape(n, g, k, 2, ho, wo)
    py = base_y[None, None] + off[:, :, :, 0]       # [N, G, K, Ho, Wo]
    px = base_x[None, None] + off[:, :, :, 1]

    # each (image, deformable group) map as h·w rows of its cpg channels
    table = x.reshape(n, g, cpg, h * w).transpose(2, 3) \
        .reshape(n * g * h * w, cpg)
    base = (torch.arange(n * g, device=dev) * (h * w)) \
        .reshape(n, g, 1, 1, 1)
    col = _bilinear_sample(table, base, py, px, h, w)   # [N,G,K,Ho,Wo,cpg]
    if mask is not None:
        col = col * mask.reshape(n, g, k, ho, wo)[..., None]
    col = col.permute(0, 1, 5, 2, 3, 4)             # [N, G, cpg, K, Ho, Wo]

    # grouped contraction with the weight
    cg_in = cin // groups
    cg_out = cout // groups
    col = col.reshape(n, groups, cg_in * k, ho * wo)
    wg = weight.reshape(groups, cg_out, cin_g * k)
    out = torch.matmul(wg, col).reshape(n, cout, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, cout, 1, 1)
    return out


class DeformConv2D(nn.Module):
    """Owns the weight [out, in / groups, kh, kw] and bias [out], both
    drawn from U(±1/sqrt(fan_in)), fan_in = in·kh·kw / groups, as the
    reference's are; ``bias_attr=False`` gives no bias. ``device=None``
    means ``cuda`` (raising where there is none); `seed` seeds the
    draws."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, device=None, seed=0):
        super().__init__()
        kw = device_and_generator(device, seed)
        ks = _pair(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.deformable_groups = deformable_groups
        self.groups = groups
        fan_in = in_channels * ks[0] * ks[1] // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, *ks, device=kw["device"]))
        I.from_attr(weight_attr, I.Uniform(-bound, bound))(
            self.weight, kw["generator"])
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.empty(out_channels,
                                                 device=kw["device"]))
            I.from_attr(bias_attr, I.Uniform(-bound, bound))(
                self.bias, kw["generator"])

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2) on the host: scores decayed by their overlap
    with higher-scoring boxes instead of suppressed one by one."""
    bb = np.asarray(_np(bboxes), np.float32)   # [N, M, 4]
    sc = np.asarray(_np(scores), np.float32)   # [N, C, M]
    device = _device(bboxes)
    N, C, M = sc.shape
    all_out, all_idx, rois_num = [], [], []
    for n in range(N):
        dets, idxs = [], []
        for c in range(C):
            if c == background_label:
                continue
            keep = np.nonzero(sc[n, c] > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-sc[n, c, keep])][:nms_top_k]
            boxes_c = bb[n, order]
            scores_c = sc[n, c, order]
            K = len(order)
            if K == 0:
                continue
            # IoU matrix (upper triangle: j suppressed by i<j)
            x1 = np.maximum(boxes_c[:, None, 0], boxes_c[None, :, 0])
            y1 = np.maximum(boxes_c[:, None, 1], boxes_c[None, :, 1])
            x2 = np.minimum(boxes_c[:, None, 2], boxes_c[None, :, 2])
            y2 = np.minimum(boxes_c[:, None, 3], boxes_c[None, :, 3])
            off = 0.0 if normalized else 1.0
            iw = np.clip(x2 - x1 + off, 0, None)
            ih = np.clip(y2 - y1 + off, 0, None)
            inter = iw * ih
            area = ((boxes_c[:, 2] - boxes_c[:, 0] + off)
                    * (boxes_c[:, 3] - boxes_c[:, 1] + off))
            iou = inter / np.maximum(area[:, None] + area[None, :] - inter,
                                     1e-10)
            iou = np.triu(iou, k=1)
            comp = iou.max(axis=0)             # max overlap with higher-score
            if use_gaussian:
                # the exponent is multiplied by sigma, as the reference's
                decay = np.exp((comp[:, None] ** 2 - iou ** 2)
                               * gaussian_sigma)
            else:
                decay = (1.0 - iou) / np.maximum(1.0 - comp[:, None], 1e-10)
            decay = np.where(np.triu(np.ones_like(iou), k=1) > 0, decay, 1.0)
            decayed = scores_c * decay.min(axis=0)
            ok = decayed > post_threshold
            for k in np.nonzero(ok)[0]:
                dets.append([c, decayed[k], *boxes_c[k]])
                idxs.append(n * M + order[k])
        if dets:
            dets = np.asarray(dets, np.float32)
            idxs = np.asarray(idxs, np.int64)
            top = np.argsort(-dets[:, 1])[:keep_top_k]
            dets, idxs = dets[top], idxs[top]
        else:
            dets = np.zeros((0, 6), np.float32)
            idxs = np.zeros((0,), np.int64)
        all_out.append(dets)
        all_idx.append(idxs)
        rois_num.append(len(dets))
    res = (_tensor(np.concatenate(all_out, 0), device),)
    if return_index:
        res = res + (_tensor(np.concatenate(all_idx, 0)[:, None], device),)
    if return_rois_num:
        res = res + (_tensor(np.asarray(rois_num, np.int32), device),)
    return res if len(res) > 1 else res[0]


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    """RPN proposals on the host, per image: decode, clip, filter, top-k,
    NMS."""
    sc = np.asarray(_np(scores), np.float32)        # [N, A, H, W]
    bd = np.asarray(_np(bbox_deltas), np.float32)   # [N, 4A, H, W]
    ims = np.asarray(_np(img_size), np.float32)     # [N, 2] (h, w)
    an = np.asarray(_np(anchors), np.float32).reshape(-1, 4)
    va = np.asarray(_np(variances), np.float32).reshape(-1, 4)
    device = _device(scores)
    N, A, H, W = sc.shape
    off = 1.0 if pixel_offset else 0.0

    rois_all, nums = [], []
    for n in range(N):
        s = sc[n].transpose(1, 2, 0).reshape(-1)          # [H*W*A]
        d = bd[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        # decode (anchor + delta, variance-scaled)
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = np.exp(np.minimum(v[:, 2] * d[:, 2], np.log(1000. / 16.))) * aw
        h = np.exp(np.minimum(v[:, 3] * d[:, 3], np.log(1000. / 16.))) * ah
        boxes = np.stack([cx - w * 0.5, cy - h * 0.5,
                          cx + w * 0.5 - off, cy + h * 0.5 - off], axis=1)
        ih, iw = ims[n]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - off)
        # min_size is at least 1.0 and, with pixel_offset, a box whose
        # centre lies outside the image is dropped, as in the reference
        ms = max(min_size, 1.0)
        bw = boxes[:, 2] - boxes[:, 0] + off
        bh = boxes[:, 3] - boxes[:, 1] + off
        keep = (bw >= ms) & (bh >= ms)
        if pixel_offset:
            cx_k = boxes[:, 0] + bw * 0.5
            cy_k = boxes[:, 1] + bh * 0.5
            keep &= (cx_k <= iw) & (cy_k <= ih)
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            kept = _nms_single(boxes, s, nms_thresh)[:post_nms_top_n]
            boxes = boxes[kept]
        rois_all.append(boxes.astype(np.float32))
        nums.append(len(boxes))
    rois = _tensor(np.concatenate(rois_all, 0) if rois_all
                   else np.zeros((0, 4), np.float32), device)
    if return_rois_num:
        return rois, _tensor(np.asarray(nums, np.int32), device)
    return rois


def read_file(filename, name=None):
    """A file's bytes as a uint8 CPU tensor."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    return torch.from_numpy(data.copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes to a CHW uint8 CPU tensor on the host (PIL,
    imported at call time)."""
    import io as _io
    from PIL import Image
    data = bytes(np.asarray(_np(x), np.uint8))
    img = Image.open(_io.BytesIO(data))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.array(arr))


def _scatter_set(out, index, vals, owns):
    """The reference's ``out.at[index].set(where(owns, vals, out[index]))``:
    updates in order (a later duplicate wins), an update whose index
    falls outside `out` dropped, as JAX's scatter drops it."""
    inside = torch.ones_like(owns)
    for i, size in zip(index, out.shape):
        inside = inside & (i < size)
    index = tuple(i[inside] for i in index)
    old = out[index]
    out[index] = torch.where(owns[inside], vals[inside].to(out.dtype), old)
    return out


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 detection loss, differentiable in `x`.

    x: [N, mask·(5+class_num), H, W] raw head output; gt_box: [N, B, 4]
    (cx, cy, w, h in image units); gt_label: [N, B]; anchors: flat (w, h)
    pairs; anchor_mask: the anchors this head predicts. Returns the loss of
    each sample, [N]. Each gt picks its best anchor by shape-only IoU over
    ALL anchors; the cell holding its centre owns the target when that
    anchor is this head's. Predictions overlapping any gt above
    `ignore_thresh` are left out of the no-object loss.

    With ``use_label_smooth`` the reference builds the class target with
    one class channel ([N, mask, 1, H, W], which its loss broadcasts over
    the classes) and scatters into it at the label's channel, so only
    label 0 lands and other labels' updates are dropped
    (`paddle_tpu/vision/ops.py:819-825`); the port computes the same
    function."""
    dev = x.device
    anchors_t = torch.tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                             device=dev)
    mask_np = np.asarray(anchor_mask, np.int64)
    n_mask = len(mask_np)
    N, _, H, W = x.shape
    pred = x.reshape(N, n_mask, 5 + class_num, H, W)
    px = torch.sigmoid(pred[:, :, 0])
    py = torch.sigmoid(pred[:, :, 1])
    pw = pred[:, :, 2]
    ph = pred[:, :, 3]
    pobj = pred[:, :, 4]
    pcls = pred[:, :, 5:]
    input_size = downsample_ratio * H

    gbv = gt_box.float()
    B = gbv.shape[1]
    gx = _div(gbv[..., 0], input_size) * W     # grid units
    gy = _div(gbv[..., 1], input_size) * H
    gw = gbv[..., 2]
    gh = gbv[..., 3]
    valid = (gw > 0) & (gh > 0)

    # best anchor per gt by shape-only IoU over ALL anchors
    aw = anchors_t[:, 0][None, None]
    ah = anchors_t[:, 1][None, None]
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best_anchor = torch.argmax(inter / union.clamp(min=1e-10), -1)

    # this head's slot of the best anchor (-1 if not this head's)
    local = -torch.ones_like(best_anchor)
    for slot, a_id in enumerate(mask_np.tolist()):
        local = torch.where(best_anchor == a_id,
                            torch.full_like(local, slot), local)

    ci = gx.to(torch.int32).clamp(0, W - 1).long()
    cj = gy.to(torch.int32).clamp(0, H - 1).long()
    owns = valid & (local >= 0)
    nn_idx = torch.arange(N, device=dev)[:, None].expand(N, B)
    sl = local.clamp(0, n_mask - 1)

    def scatter(vals, fill=0.0):
        out = torch.full((N, n_mask, H, W), fill, dtype=torch.float32,
                         device=dev)
        return _scatter_set(out, (nn_idx, sl, cj, ci), vals, owns)

    tx = scatter(gx - torch.floor(gx))
    ty = scatter(gy - torch.floor(gy))
    mask_aw = anchors_t[mask_np][:, 0]
    mask_ah = anchors_t[mask_np][:, 1]
    tw = scatter(torch.log((gw / mask_aw[sl].clamp(min=1e-9))
                           .clamp(min=1e-9)))
    th = scatter(torch.log((gh / mask_ah[sl].clamp(min=1e-9))
                           .clamp(min=1e-9)))
    tobj = scatter(torch.ones_like(gx))
    tscore = scatter(gt_score.float() if gt_score is not None
                     else torch.ones_like(gx))
    box_scale = scatter(2.0 - gw * gh / (input_size * input_size))

    # class targets: a one-hot scatter
    cls_idx = gt_label.to(torch.int32).clamp(0, class_num - 1).long()
    smooth_pos = 1.0
    if use_label_smooth:
        delta = 1.0 / max(class_num, 1)
        smooth_pos = 1.0 - delta
        tcls = torch.where(tobj[:, :, None] > 0, delta, 0.0)
    else:
        tcls = torch.zeros((N, n_mask, class_num, H, W), device=dev)
    tcls = _scatter_set(tcls, (nn_idx, sl, cls_idx, cj, ci),
                        torch.full_like(gx, smooth_pos), owns)

    # ignore mask: predicted boxes with IoU > thresh against any gt
    grid_x = torch.arange(W, dtype=torch.float32, device=dev)[None, None,
                                                              None]
    grid_y = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
    with torch.no_grad():
        bx = _div(px + grid_x, W) * input_size
        by = _div(py + grid_y, H) * input_size
        bw = torch.exp(pw.clamp(-10, 10)) * mask_aw[None, :, None, None]
        bh = torch.exp(ph.clamp(-10, 10)) * mask_ah[None, :, None, None]
        p1x, p1y = bx - bw / 2, by - bh / 2
        p2x, p2y = bx + bw / 2, by + bh / 2
        g1x = gbv[..., 0] - gbv[..., 2] / 2
        g1y = gbv[..., 1] - gbv[..., 3] / 2
        g2x = gbv[..., 0] + gbv[..., 2] / 2
        g2y = gbv[..., 1] + gbv[..., 3] / 2
        iw = (torch.minimum(p2x[..., None], g2x[:, None, None, None])
              - torch.maximum(p1x[..., None], g1x[:, None, None, None]))
        ih = (torch.minimum(p2y[..., None], g2y[:, None, None, None])
              - torch.maximum(p1y[..., None], g1y[:, None, None, None]))
        inter_p = iw.clamp(min=0) * ih.clamp(min=0)
        area_p = (bw * bh)[..., None]
        area_g = ((g2x - g1x) * (g2y - g1y))[:, None, None, None]
        iou_pg = inter_p / (area_p + area_g - inter_p).clamp(min=1e-10)
        iou_pg = torch.where(valid[:, None, None, None], iou_pg, 0.0)
        ignore = iou_pg.amax(-1) > ignore_thresh

    def bce(logit, target):
        return (logit.clamp(min=0) - logit * target
                + torch.log1p(torch.exp(-logit.abs())))

    obj_mask = tobj > 0
    loss_xy = (bce(pred[:, :, 0], tx) + bce(pred[:, :, 1], ty)) \
        * box_scale * tscore
    loss_wh = ((pw - tw).abs() + (ph - th).abs()) * box_scale * tscore
    loss_obj = bce(pobj, torch.ones_like(pobj)) * tscore
    loss_noobj = bce(pobj, torch.zeros_like(pobj)) * (~ignore)
    loss_cls = bce(pcls, tcls).sum(2) * tscore
    per = torch.where(obj_mask, loss_xy + loss_wh + loss_obj + loss_cls,
                      loss_noobj)
    return per.reshape(N, -1).sum(-1)
