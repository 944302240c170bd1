"""The plain PIPs model: forward, training loss and optimizer, in plain PyTorch.

This is the yardstick the benchmark holds the port to. It follows the
published model (aharley/pips ``nets/pips.py``, ``Pips(S=8)``) in the form
that ``pips_tpu_torch/models/pips.py`` states it: a residual CNN encoder, a
4-level correlation pyramid sampled in (2r+1)^2 patches, a 12-block
MLP-Mixer refiner over the S frames, a feature updater and a visibility head.
It imports nothing of the program and takes nothing the program made: the
parameters come in as a dict keyed like ``Pips.state_dict()``.

Every product (conv, matmul, batched matmul) goes through ``Precision``:
``Precision("float32")`` computes in f32 (TF32 must be off, which
``reference_mode`` does); ``Precision("float8")`` runs every product as
float8 training runs it, the step below the port's bfloat16 that the
control takes: e4m3 operands under a per-tensor scale, and in the backward
an e5m2 gradient. Elementwise work stays f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F


def round8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to a float8 ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest, returned in f32."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


class _MM8(torch.autograd.Function):
    """a @ b on e4m3 operands; in the backward the incoming gradient is
    rounded to e5m2 and multiplied with the rounded operands, as float8
    training runs its products. b is 2-D or has a's leading dims."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = round8(a, torch.float8_e4m3fn), round8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = round8(g, torch.float8_e5m2)
        ga = g8 @ b8.transpose(-1, -2)
        if b8.dim() == 2:
            gb = a8.reshape(-1, a8.shape[-1]).t() @ g8.reshape(-1, g8.shape[-1])
        else:
            gb = a8.transpose(-1, -2) @ g8
        return ga, gb


class _Conv8(torch.autograd.Function):
    """conv2d on e4m3 operands, its backward on an e5m2 gradient."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad):
        x8, w8 = round8(x, torch.float8_e4m3fn), round8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(x8, w8)
        ctx.conf = (stride, pad)
        return F.conv2d(x8, w8, b, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, g):
        x8, w8 = ctx.saved_tensors
        stride, pad = ctx.conf
        g8 = round8(g, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(x8.shape, w8, g8, stride=stride, padding=pad)
        gw = torch.nn.grad.conv2d_weight(x8, w8.shape, g8, stride=stride, padding=pad)
        return gx, gw, g.sum(dim=(0, 2, 3)), None, None


class Precision:
    """How the products are computed: "float32" (operands as they are) or
    "float8" (e4m3 operands under a per-tensor scale, e5m2 gradients in the
    backward, ``_MM8`` and ``_Conv8``)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"precision is float32 or float8, got {name!r}")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "float8":
            return _MM8.apply(a.float(), b.float())
        return torch.matmul(a.float(), b.float())

    def conv(self, x, w, b, stride: int, pad: int) -> torch.Tensor:
        if self.name == "float8":
            return _Conv8.apply(x.float(), w.float(), b.float(), stride, pad)
        return F.conv2d(x.float(), w.float(), b.float(), stride=stride, padding=pad)


@contextlib.contextmanager
def reference_mode():
    """f32 products in f32: TF32 off for matmuls and cuDNN convs, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# --------------------------------------------------------------------------- encoder

def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def conv(p: dict, name: str, x, prec: Precision, stride: int, pad: int):
    return prec.conv(x, p[name + ".weight"], p[name + ".bias"], stride, pad)


def res_block(p: dict, name: str, x, prec: Precision, stride: int):
    y = F.relu(instance_norm(conv(p, name + ".conv1", x, prec, stride, 1)))
    y = F.relu(instance_norm(conv(p, name + ".conv2", y, prec, 1, 1)))
    if stride != 1:
        x = instance_norm(conv(p, name + ".downsample", x, prec, stride, 0))
    return F.relu(x + y)


def resize_ac(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize of NCHW x to ``hw`` with aligned corners."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


def encode(p: dict, cfg: dict, rgbs: torch.Tensor, prec: Precision) -> torch.Tensor:
    """rgbs (B, S, H, W, 3) in [0, 255] -> fmaps (B, S, H/stride, W/stride, latent)."""
    B, S, H, W, _ = rgbs.shape
    stride = cfg["stride"]
    x = (2.0 * (rgbs.float() / 255.0) - 1.0).reshape(B * S, H, W, 3).permute(0, 3, 1, 2)
    out_hw = (H // stride, W // stride)
    x = F.relu(instance_norm(conv(p, "fnet.conv1", x, prec, 2, 3)))
    feats = []
    for i in range(4):
        for j in range(2):
            x = res_block(p, f"fnet.layer{i + 1}_{j}", x, prec, 2 if (i > 0 and j == 0) else 1)
        feats.append(resize_ac(x, out_hw))
    x = F.relu(instance_norm(conv(p, "fnet.conv2", torch.cat(feats, 1), prec, 1, 1)))
    f = conv(p, "fnet.conv3", x, prec, 1, 0)
    return f.permute(0, 2, 3, 1).reshape(B, S, out_hw[0], out_hw[1], f.shape[1])


# --------------------------------------------------------------------------- correlation

def pyramid(fmaps: torch.Tensor, levels: int) -> list:
    """(B, S, H, W, C) maps, each level 2x2 average pooled (floor size) from the last."""
    out = [fmaps]
    for _ in range(levels - 1):
        B, S, H, W, C = fmaps.shape
        x = fmaps.reshape(B * S, H, W, C).permute(0, 3, 1, 2)
        x = F.avg_pool2d(x, 2)
        fmaps = x.permute(0, 2, 3, 1).reshape(B, S, H // 2, W // 2, C)
        out.append(fmaps)
    return out


def score_maps(fm: torch.Tensor, targets: torch.Tensor, prec: Precision) -> torch.Tensor:
    """targets (B, S, N, C) against fm (B, S, H, W, C) -> (B, S, N, H, W) f32."""
    B, S, H, W, C = fm.shape
    N = targets.shape[2]
    c = prec.mm(targets.reshape(B * S, N, C), fm.reshape(B * S, H * W, C).transpose(1, 2))
    return (c / math.sqrt(C)).reshape(B, S, N, H, W)


def sample_zeros(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (M, H, W) at pixel coords x, y (M, K); taps off
    the map read zero."""
    M, H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = img.reshape(M, H * W)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (1 - (x - x0 - dx).abs()) * (1 - (y - y0 - dy).abs())
            ix, iy = (x0 + dx).long(), (y0 + dy).long()
            inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = flat.gather(1, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
            out = out + wgt * torch.where(inside, v, torch.zeros_like(v))
    return out


def sample_patches(corrs: list, coords: torch.Tensor, r: int) -> torch.Tensor:
    """A (2r+1)^2 patch of every level's maps around coords (B, S, N, 2), level-0
    units; patch[i, j] sits at (x + o_i, y + o_j), flattened i-major."""
    B, S, N, _ = coords.shape
    P = 2 * r + 1
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    out = []
    for lvl, c in enumerate(corrs):
        H, W = c.shape[-2:]
        xy = coords / 2.0 ** lvl
        x = (xy[..., 0, None, None] + offs[:, None]).expand(B, S, N, P, P)
        y = (xy[..., 1, None, None] + offs[None, :]).expand(B, S, N, P, P)
        patch = sample_zeros(c.reshape(B * S * N, H, W), x.reshape(B * S * N, P * P),
                             y.reshape(B * S * N, P * P))
        out.append(patch.reshape(B, S, N, P * P))
    return torch.cat(out, -1)


def sample_border(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (B, H, W, C) at x, y (B, N), the border
    replicated off the map -> (B, N, C)."""
    B, H, W, C = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (1 - (x - x0 - dx).abs()) * (1 - (y - y0 - dy).abs())
            ix = (x0 + dx).long().clamp(0, W - 1)
            iy = (y0 + dy).long().clamp(0, H - 1)
            v = img.reshape(B, H * W, C).gather(1, (iy * W + ix)[..., None].expand(-1, -1, C))
            out = out + wgt[..., None] * v
    return out


# --------------------------------------------------------------------------- refiner

def layer_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".scale"].float(), p[name + ".bias"].float(),
                        eps=1e-5)


def dense(p: dict, name: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(x, p[name + ".kernel"]) + p[name + ".bias"].float()


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def flow_embedding(flow: torch.Tensor, C: int = 64) -> torch.Tensor:
    """(M, S, 3) -> (M, S, 3C + 3): per axis sin/cos interleaved at
    frequencies arange(0, C, 2) * 1000 / C, then the raw values."""
    M, S, _ = flow.shape
    freqs = torch.arange(0, C, 2, dtype=torch.float32, device=flow.device) * (1000.0 / C)
    ang = flow[..., None] * freqs
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(M, S, 3 * C)
    return torch.cat([pe, flow], -1)


def mixer(p: dict, cfg: dict, x: torch.Tensor, prec: Precision, block=None) -> torch.Tensor:
    """The MLP-Mixer over (M, S, kitchen) -> (M, S * (latent + 2)). ``block``
    wraps each mixer block (e.g. in a checkpoint); None runs it as it is."""
    pre = "delta_block.to_delta"
    x = dense(p, pre + ".embed", x, prec)

    def one(d, x):
        t = layer_norm(p, f"{pre}.block{d}_token_norm", x).transpose(1, 2)  # (M, D, S)
        t = gelu(dense(p, f"{pre}.block{d}_token.fc1", t, prec))
        x = x + dense(p, f"{pre}.block{d}_token.fc2", t, prec).transpose(1, 2)
        h = gelu(dense(p, f"{pre}.block{d}_chan.fc1",
                       layer_norm(p, f"{pre}.block{d}_chan_norm", x), prec))
        return x + dense(p, f"{pre}.block{d}_chan.fc2", h, prec)

    for d in range(cfg["mixer_depth"]):
        x = one(d, x) if block is None else block(lambda t, d=d: one(d, t), x)
    x = layer_norm(p, pre + ".final_norm", x).mean(dim=1)
    return dense(p, pre + ".head", x, prec)


def track(p: dict, cfg: dict, fmaps: torch.Tensor, xys: torch.Tensor, iters: int,
          prec: Precision, is_train: bool = False, ce_gt: Optional[tuple] = None,
          block=None):
    """fmaps (B, S, H8, W8, C), xys (B, N, 2) frame-0 pixels. Returns the
    per-iteration coords (I, B, S, N, 2) in pixels, the visibility logits
    (B, S, N), and with ``ce_gt = (trajs, vis, valids)`` the score-map CE
    averaged over the iterations (None otherwise)."""
    B, S, H8, W8, C = fmaps.shape
    N = xys.shape[1]
    stride, r = cfg["stride"], cfg["corr_radius"]
    coords = (xys.float() / stride)[:, None].expand(B, S, N, 2)
    pyr = pyramid(fmaps, cfg["corr_levels"])
    feat0 = sample_border(fmaps[:, 0], coords[:, 0, :, 0], coords[:, 0, :, 1])
    feats = feat0[:, None].expand(B, S, N, C)
    start = coords
    fused = None
    if ce_gt is not None:  # the train-time maps: every level resized to H8 x W8, summed
        fused = 0.0
        for fm in pyr:
            x = fm.reshape(B * S, *fm.shape[2:]).permute(0, 3, 1, 2)
            fused = fused + resize_ac(x, (H8, W8)).permute(0, 2, 3, 1)
        fused = fused.reshape(B, S, H8, W8, C)
    times = torch.linspace(0.0, float(S), S, device=fmaps.device).reshape(1, S, 1)
    preds, ce = [], []
    for _ in range(iters):
        coords = coords.detach()
        corrs = [score_maps(fm, feats, prec) for fm in pyr]
        if ce_gt is not None:
            trajs, vis, valids = ce_gt
            ce.append(score_map_ce(score_maps(fused, feats, prec), trajs / stride, vis, valids))
        fcorr = sample_patches(corrs, coords, r)
        flow = (coords - coords[:, :1]).transpose(1, 2).reshape(B * N, S, 2)
        flow = torch.cat([flow, times.expand(B * N, S, 1)], -1)
        f_ = feats.transpose(1, 2).reshape(B * N, S, C)
        kitchen = torch.cat([f_, fcorr.transpose(1, 2).reshape(B * N, S, -1),
                             flow_embedding(flow)], -1)
        delta = mixer(p, cfg, kitchen, prec, block).reshape(B * N, S, C + 2)
        dfeat = delta[:, :, 2:].reshape(B * N * S, C)
        upd = gelu(dense(p, "ffeat_updater", layer_norm(p, "ffeat_norm", dfeat), prec))
        feats = (upd + f_.reshape(B * N * S, C)).reshape(B, N, S, C).transpose(1, 2)
        coords = coords + delta[:, :, :2].reshape(B, N, S, 2).transpose(1, 2)
        if not is_train:
            coords = torch.cat([start[:, :1], coords[:, 1:]], 1)
        preds.append(coords * stride)
    vis_e = dense(p, "vis_predictor", feats.reshape(B * S * N, C), prec).reshape(B, S, N)
    return torch.stack(preds), vis_e, (sum(ce) / len(ce) if ce else None)


def window(p: dict, cfg: dict, rgbs: torch.Tensor, xys: torch.Tensor, iters: int,
           prec: Precision):
    """One served window: (trajs (B, S, N, 2), vis logits (B, S, N)) of the
    last iteration."""
    with torch.no_grad():
        trajs, vis, _ = track(p, cfg, encode(p, cfg, rgbs, prec), xys, iters, prec)
    return trajs[-1], vis


# --------------------------------------------------------------------------- training

EPS = 1e-6


def masked_mean(x, mask, dim=None):
    if dim is None:
        return (x * mask).sum() / (EPS + mask.sum())
    return (x * mask).sum(dim=dim) / (EPS + mask.sum(dim=dim))


def balanced_bce(pred, gt, valid):
    """Sigmoid BCE on logits, positives (gt > 0.95) and negatives (gt < 0.05)
    each a masked mean, the two summed."""
    pos = (gt > 0.95).float()
    neg = (gt < 0.05).float()
    loss = F.softplus(-(pos * 2.0 - 1.0) * pred)
    return masked_mean(loss, pos * valid) + masked_mean(loss, neg * valid)


def score_map_ce(fcp, trajs8, vis, valids):
    """The balanced BCE of score maps fcp (B, S, N, H8, W8) against a one-hot
    map at each ground-truth cell (trajs8 in map units, rounded half to
    even); maps whose cell is off the map, occluded or invalid are left out."""
    B, S, N, H8, W8 = fcp.shape
    xy = torch.round(trajs8)
    x, y = xy[..., 0], xy[..., 1]
    sel = ((x >= 0) & (x <= W8 - 1) & (y >= 0) & (y <= H8 - 1) & (valids > 0)
           & (vis > 0)).float()
    gt = ((torch.arange(H8, device=fcp.device).view(H8, 1) == y[..., None, None])
          & (torch.arange(W8, device=fcp.device).view(1, W8) == x[..., None, None])).float()
    loss = F.softplus(-(gt * 2.0 - 1.0) * fcp)
    m = sel[..., None, None]
    return masked_mean(loss, gt * m) + masked_mean(loss, (1.0 - gt) * m)


def flip_double(rgbs, trajs, vis, valids):
    """Horizontal flips appended to the batch, then vertical flips of all of it."""
    H, W = rgbs.shape[2], rgbs.shape[3]
    for dim, axis, size in ((3, 0, W), (2, 1, H)):
        t = trajs.clone()
        t[..., axis] = size - 1 - trajs[..., axis]
        rgbs = torch.cat([rgbs, torch.flip(rgbs, dims=(dim,))])
        trajs = torch.cat([trajs, t])
        vis, valids = torch.cat([vis, vis]), torch.cat([valids, valids])
    return rgbs, trajs, vis, valids


def train_loss(p: dict, cfg: dict, batch: dict, iters: int, prec: Precision, block=None):
    """The training loss of one batch (B clips, doubled twice by flips):
    gamma-weighted L1 over the iterations + 10 * visibility BCE + score-map
    CE, and those three terms by name."""
    rgbs, trajs, vis, valids = flip_double(*(batch[k].float() for k in
                                             ("rgbs", "trajs", "visibles", "valids")))
    fmaps = encode(p, cfg, rgbs, prec)
    preds, vis_e, ce = track(p, cfg, fmaps, trajs[:, 0], iters, prec, is_train=True,
                             ce_gt=(trajs, vis, valids), block=block)
    I = preds.shape[0]
    w = 0.8 ** torch.arange(I - 1, -1, -1, dtype=torch.float32, device=preds.device)
    l1 = (preds - trajs[None]).abs().mean(-1)
    seq = (masked_mean(l1, valids[None].expand_as(l1), dim=(1, 2, 3)) * w).sum() / I
    vis_loss = balanced_bce(vis_e, vis, valids)
    return seq + 10.0 * vis_loss + ce, {"seq": seq, "vis": vis_loss, "ce": ce}


def onecycle_rate(step: int, max_lr: float, total_steps: int, pct_start: float = 0.05,
                  div_factor: float = 25.0, final_div_factor: float = 1e4) -> float:
    """The rate of optimizer step ``step`` (from 0): linear warm-up from
    max_lr / 25 over round(0.05 * total) steps, then linear down to
    max_lr / 25 / 1e4."""
    lo = max_lr / div_factor
    warm = max(int(round(pct_start * total_steps)), 1)
    if step < warm:
        return lo + (max_lr - lo) * step / warm
    down = max(total_steps - warm, 1)
    return max_lr + (lo / final_div_factor - max_lr) * min(step - warm, down) / down


class AdamW:
    """Global-norm clip at ``clip`` (scale only when the norm reaches it),
    then AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay) at the
    one-cycle rate over ``num_steps + 100`` steps."""

    def __init__(self, params: dict, lr: float, num_steps: int, wdecay: float = 1e-4,
                 clip: float = 5.0):
        self.p = params
        self.lr, self.total, self.wd, self.clip = lr, num_steps + 100, wdecay, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """One update; returns the clipped grads it used."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = float(self.clip / norm) if float(norm) >= self.clip else 1.0
        rate = onecycle_rate(self.t, self.lr, self.total)
        self.t += 1
        used = {}
        for k, p in self.p.items():
            g = grads[k] * scale
            used[k] = g
            p.mul_(1.0 - rate * self.wd)
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            mhat = self.m[k] / (1.0 - 0.9 ** self.t)
            vhat = self.v[k] / (1.0 - 0.999 ** self.t)
            p.sub_(rate * mhat / (vhat.sqrt() + 1e-8))
        return used
