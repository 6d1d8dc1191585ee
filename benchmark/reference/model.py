"""The DH3D network in plain PyTorch, f32, as the paper and the reference
code describe it: dense 128-D local descriptors, a keypoint attention score
per point and an attention-weighted NetVLAD global descriptor.

Parameters are a flat dict of tensors under the names of the layer tree
(`param_shapes` lists them: `<module path>.<leaf>`); BatchNorm running
statistics are entries `<path>.mean` / `<path>.var` of the same dict.
`forward(cfg, params, points, train=...)` takes that dict; in train mode
BatchNorm uses the batch's statistics, mean(x) and max(0, mean(x^2) -
mean(x)^2) over every axis but the channel, and returns the running
statistics moved as m * old + (1 - m) * new (m = 0.9, 0.999 in NetVLAD).

Layers (reference `core/backbones.py`, `core/layers.py`):
  conv_pointset  out[n] = sum_k (f[nk] - f[n0]) @ theta + bias
  flexconv       out[n] = sum_k (bias + sum_d delta_kd theta_d)^T f[nk]
                 + feature_bias, delta_k = pos[nk] - pos[n0]
  flex_pool      max over the neighbourhood
  Conv1x1        Dense -> BN -> relu
  SE residual    relu(x + x * sigmoid(f2(relu(f1(maxpool(x))))))
  3-NN upsample  inverse squared-distance weights of the 3 nearest
A cloud is sorted along the Z-order curve first when the config asks for
it (`morton_order` and not `morton_presorted`); eval outputs come back in
the input order, train outputs stay sorted, as the losses read them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.geometry import fps, knn, morton_perm, take

BN_EPS = 1e-5
CLUSTERS = 64
VLAD_OUT = 256


def l2n(x, dim=-1, eps=1e-8):
    """x / sqrt(max(sum(x^2), eps)) (tf.nn.l2_normalize)."""
    return x * torch.rsqrt(torch.clamp_min(torch.sum(x * x, dim=dim,
                                                     keepdim=True), eps))


# ------------------------------ the layer tree ------------------------------

def _bn(p, name, c):
    for leaf in ("scale", "bias", "mean", "var"):
        p[f"{name}.{leaf}"] = (c,)


def _conv1x1(p, name, din, dout, bn=True):
    p[f"{name}.dense.weight"] = (dout, din)
    p[f"{name}.dense.bias"] = (dout,)
    if bn:
        _bn(p, f"{name}.norm", dout)


def _flexconv(p, name, din, dout):
    p[f"{name}.flexconv.position_theta"] = (3, din, dout)
    p[f"{name}.flexconv.position_bias"] = (din, dout)
    p[f"{name}.flexconv.feature_bias"] = (dout,)
    _bn(p, f"{name}.norm", dout)


def _se(p, name, c):
    _conv1x1(p, f"{name}.f1", c, c // 4, bn=False)
    _conv1x1(p, f"{name}.f2", c // 4, c, bn=False)


def param_shapes(cfg) -> dict:
    """{name: shape} of every parameter and BN statistic the config's model
    holds, in the layer tree's order."""
    p = {}
    lb = "local_backbone"
    p[f"{lb}.initconv.conv.theta"] = (3, 32)
    p[f"{lb}.initconv.conv.bias"] = (32,)
    _bn(p, f"{lb}.initconv.norm", 32)
    _flexconv(p, f"{lb}.stage1.flexconv_0", 32, 64)
    _flexconv(p, f"{lb}.stage1.flexconv_1", 64, 64)
    _se(p, f"{lb}.stage1.se", 64)
    _conv1x1(p, f"{lb}.before_stage2_conv1d", 64, 64)
    _flexconv(p, f"{lb}.stage2.flexconv_0", 64, 128)
    _flexconv(p, f"{lb}.stage2.flexconv_1", 128, 128)
    _se(p, f"{lb}.stage2.se", 128)
    _conv1x1(p, f"{lb}.stage2.concat_conv1d", 192, 128)
    _conv1x1(p, f"{lb}.local_stage1_shortcut", 64, 128)
    if cfg["detection"]:
        dims = [128, 128, 256, 1024]
        for i in range(3):
            _conv1x1(p, f"detection_block.detec_conv{i}", dims[i],
                     dims[i + 1])
        p["detection_block.detec_conv_fc.weight"] = (1, 1024)
        p["detection_block.detec_conv_fc.bias"] = (1,)
    if cfg["extract_global"]:
        D = cfg["gl_dims"][-1]
        _flexconv(p, "global_backbone.global_before_assemble.flexconv_0",
                  128, D)
        _conv1x1(p, "globalatt.detec_conv0", D, 1024)
        p["globalatt.detec_conv_fc.weight"] = (1, 1024)
        p["globalatt.detec_conv_fc.bias"] = (1,)
        g = "global_assemble"
        p[f"{g}.cluster_weights"] = (D, CLUSTERS)
        p[f"{g}.cluster_weights2"] = (1, D, CLUSTERS)
        p[f"{g}.hidden1_weights"] = (D * CLUSTERS, VLAD_OUT)
        _bn(p, f"{g}.cluster_bn", CLUSTERS)
        _bn(p, f"{g}.hidden_bn", VLAD_OUT)
        p[f"{g}.gating.gating_weights"] = (VLAD_OUT, VLAD_OUT)
        _bn(p, f"{g}.gating.gating_bn", VLAD_OUT)
    return p


def is_statistic(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


def is_dense_kernel(name: str) -> bool:
    """The weight-decay set: every Dense kernel ('.*/W' upstream)."""
    return name.endswith("dense.weight") or name.endswith("conv_fc.weight")


# ------------------------------- the forward --------------------------------

class Net:
    """One forward's state: the parameters, the mode and the moved
    running statistics (`stats`, train mode) and the batch statistics
    of the BatchNorms over points (`batch`)."""

    def __init__(self, params: dict, train: bool):
        self.p = params
        self.train = train
        self.stats = {}
        self.batch = {}

    def bn(self, x, name, momentum=0.9):
        p = self.p
        if self.train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            if x.dim() > 2:  # over points, not one row a cloud
                self.batch[f"{name}.mean"] = mean.detach()
                self.batch[f"{name}.var"] = var.detach()
            m = momentum
            self.stats[f"{name}.mean"] = \
                m * p[f"{name}.mean"] + (1 - m) * mean.detach()
            self.stats[f"{name}.var"] = \
                m * p[f"{name}.var"] + (1 - m) * var.detach()
        else:
            mean, var = p[f"{name}.mean"], p[f"{name}.var"]
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * p[f"{name}.scale"]) \
            + p[f"{name}.bias"]

    def dense(self, x, name):
        return F.linear(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"])

    def conv1x1(self, x, name, bn=True, act=torch.relu):
        x = self.dense(x, f"{name}.dense")
        if bn:
            x = self.bn(x, f"{name}.norm")
        return act(x)

    def flexconv(self, feat, pos, nbh, name):
        p = self.p
        theta = p[f"{name}.flexconv.position_theta"]  # [3, Din, Dout]
        f_k = take(feat, nbh)  # [B, N, K, Din]
        p_k = take(pos, nbh)
        delta = p_k - p_k[:, :, :1]  # [B, N, K, 3]
        w = torch.cat([torch.ones_like(delta[..., :1]), delta], dim=-1)
        m = torch.einsum("bnkp,bnkc->bnpc", w, f_k)  # [B, N, 4, Din]
        W = torch.cat([p[f"{name}.flexconv.position_bias"][None], theta])
        out = m.reshape(*m.shape[:2], -1) @ W.reshape(-1, W.shape[-1])
        out = out + p[f"{name}.flexconv.feature_bias"]
        return torch.relu(self.bn(out, f"{name}.norm"))

    def se(self, x, nbh, name):
        pool = take(x, nbh).amax(dim=2)
        s = self.conv1x1(self.conv1x1(pool, f"{name}.f1", bn=False),
                         f"{name}.f2", bn=False, act=torch.sigmoid)
        return torch.relu(x + x * s)

    def stage(self, xyz, feat, name, nconv, nbh=None, sub=None,
              concat=False, se=True):
        """flex_conv_dilate: [subsample] -> kNN -> flexconvs -> [SE] ->
        [3-NN upsample] -> [concat + 1x1].  `sub` = (kp_idx, knn, three
        nearest (d2, idx)) of a dilated level, shared by the stages at it."""
        if sub is not None:
            kp, nbh, (d2, idx3) = sub
            pts, x = take(xyz, kp), take(feat, kp)
        else:
            pts, x = xyz, feat
        for i in range(nconv):
            x = self.flexconv(x, pts, nbh, f"{name}.flexconv_{i}")
        if se:
            x = self.se(x, nbh, f"{name}.se")
        if sub is not None:
            inv = torch.reciprocal(torch.clamp_min(d2, 1e-10))
            w = inv / inv.sum(dim=-1, keepdim=True)
            x = torch.sum(w[..., None] * take(x, idx3), dim=2)
        if concat:
            x = self.conv1x1(torch.cat([x, feat], dim=-1),
                             f"{name}.concat_conv1d")
        return x


def dilated_level(xyz, dilate, sorted_order, knn_num=8):
    """A level's geometry: FPS of N / dilate points (in ascending index
    order under the Z-order sort), their self kNN, and the 3 nearest of
    them for every point of the full cloud."""
    kp = fps(xyz, xyz.shape[1] // dilate)
    if sorted_order:
        kp = torch.sort(kp, dim=-1).values
    pts = take(xyz, kp)
    nbh, _ = knn(pts, pts, knn_num)
    idx3, d2 = knn(xyz, pts, 3)
    return kp, nbh, (d2, idx3)


def forward(cfg, params: dict, points: torch.Tensor, train: bool = False,
            sample_inds: torch.Tensor | None = None, net: Net | None = None):
    """points [B, N, 3] -> (outs, moved statistics); `net`, when given,
    is the Net to run (its `batch` then holds the batch statistics).  outs: xyz, feat
    (raw), local_desc (unit), attention [B, N, 1] (detection),
    global_desc [B, 256] (extract_global); with `sample_inds` [B, M] (ids
    into the points as given), xyz_sampled, feat_sampled, att_sampled and
    the ids in the order the model worked in (`sample_nodes_concat`)."""
    net = net or Net(params, train)
    inv = None
    if cfg["morton_order"] and not cfg.get("morton_presorted"):
        perm = morton_perm(points)
        inv = torch.argsort(perm, dim=1)
        points = take(points, perm)
        if sample_inds is not None:
            sample_inds = torch.gather(inv, 1, sample_inds)

    def back(x):
        return x if inv is None or train else take(x, inv)

    nbh, _ = knn(points, points, cfg["knn_num"])
    nbh = nbh[..., :8]
    lb = "local_backbone"
    diff = take(points, nbh) - take(points, nbh[..., :1])
    init = diff.sum(dim=2) @ params[f"{lb}.initconv.conv.theta"] \
        + params[f"{lb}.initconv.conv.bias"]
    init = torch.relu(net.bn(init, f"{lb}.initconv.norm"))
    init = take(init, nbh).amax(dim=2)
    x1 = net.stage(points, init, f"{lb}.stage1", 2, nbh=nbh)
    level = dilated_level(points, cfg.get("dilate") or 8,
                          bool(cfg["morton_order"]))
    x2 = net.stage(points, net.conv1x1(x1, f"{lb}.before_stage2_conv1d"),
                   f"{lb}.stage2", 2, sub=level, concat=True)
    feat = net.conv1x1(x1, f"{lb}.local_stage1_shortcut") + x2
    desc = l2n(feat)
    outs = {"xyz": back(points), "feat": back(feat), "local_desc": back(desc)}
    if cfg["detection"]:
        x = feat
        for i in range(3):
            x = net.conv1x1(x, f"detection_block.detec_conv{i}")
        att = torch.sigmoid(net.dense(x, "detection_block.detec_conv_fc"))
        outs["attention"] = back(att)
    if sample_inds is not None:
        outs["sample_nodes_concat"] = sample_inds
        outs["xyz_sampled"] = take(points, sample_inds)
        outs["feat_sampled"] = take(desc, sample_inds)
        if cfg["detection"]:
            outs["att_sampled"] = take(att, sample_inds)[..., 0]
    if cfg["extract_global"]:
        g = net.stage(points, feat, "global_backbone.global_before_assemble",
                      1, sub=level, se=False)
        x = net.conv1x1(g, "globalatt.detec_conv0")
        gatt = torch.sigmoid(net.dense(x, "globalatt.detec_conv_fc"))
        outs["global_desc"] = l2n(netvlad(net, g, gatt))
    return outs, net.stats


def netvlad(net: Net, features, att):
    """Attention-weighted NetVLAD over 64 clusters, FC to 256, BN and
    context gating (reference `core/backbones.py:202-320`)."""
    p, g = net.p, "global_assemble"
    B = features.shape[0]
    x = l2n(features)
    act = net.bn(x @ p[f"{g}.cluster_weights"], f"{g}.cluster_bn",
                 momentum=0.999)
    act = torch.softmax(act, dim=-1) * att
    a = act.sum(dim=1, keepdim=True) * p[f"{g}.cluster_weights2"]
    vlad = x.transpose(1, 2) @ act - a  # [B, D, K]
    vlad = l2n(l2n(vlad, dim=1).reshape(B, -1))
    h = net.bn(vlad @ p[f"{g}.hidden1_weights"], f"{g}.hidden_bn",
               momentum=0.999)
    gates = net.bn(h @ p[f"{g}.gating.gating_weights"],
                   f"{g}.gating.gating_bn", momentum=0.999)
    return h * torch.sigmoid(gates)
