"""DINO label-propagation tracking baseline (counterpart of
``pips_tpu/models/dino.py``; capability parity with the reference's
``utils/test.py:6-194``): per-frame ViT features; for each target frame a
masked affinity (a 12-patch neighborhood, temperature 0.1, the top 5 a
query) against frame 1 and a queue of the last 7 frames; propagated one-hot
keypoint heat maps; a soft argmax.

The ViT is flax's, written out: ``ViTBlock``'s attention is
``nn.MultiHeadDotProductAttention`` (q/k/v projections kept in flax's
(dim, heads, head_dim) layout, q scaled by 1/sqrt(head_dim), softmax in f32,
the out projection (heads, head_dim, dim)), so ``load_flax_params`` loads
``torchport.convert_dino_vit_state_dict``'s tree leaf for leaf. Weights come
only from a local file (``evals.common.load_dino_state_dict``).

At a 1080x1920 frame the patch grid is 135x240, 32,400 tokens: a head's
attention scores, the neighborhood mask and the affinity against 8 source
frames would take 4.2, 4.2 and 33.6 GB at once. ``attention`` and
``label_propagation`` compute the same functions in chunks of heads and
queries of at most ``CHUNK_ELEMS`` elements; label propagation takes the
mask's radius, makes its rows per chunk and computes only the band of
source rows the mask lets through.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pips_tpu_torch.convert import load_flax_params
from pips_tpu_torch.models.mixer import Dense, LayerNorm, gelu
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.ops.resize import resize_half_pixel

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.228, 0.224, 0.225], np.float32)
CHUNK_ELEMS = 1 << 27  # f32 elements of one chunk's scores or affinities (512 MB)


@contextlib.contextmanager
def full_f32_matmuls():
    """Matmuls in full f32 (no TF32) inside, as JAX's
    ``Precision.HIGHEST``; the setting is restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class HeadDense(nn.Module):
    """flax ``DenseGeneral`` to (heads, head_dim): kernel (dim, heads, head_dim)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(dim, heads, dim // heads))
        self.bias = nn.Parameter(torch.zeros(heads, dim // heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, hd = self.kernel.shape
        y = x @ self.kernel.reshape(d, h * hd) + self.bias.reshape(h * hd)
        return y.unflatten(-1, (h, hd))


class OutDense(nn.Module):
    """flax ``DenseGeneral`` over (heads, head_dim): kernel (heads, head_dim, dim)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(heads, dim // heads, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, hd, d = self.kernel.shape
        return x.flatten(-2) @ self.kernel.reshape(h * hd, d) + self.bias


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v per (batch, head), the softmax in f32; q, k, v:
    (B, T, heads, hd), q already scaled. Chunks of (batch, head) pairs, then
    of queries, each hold at most ``CHUNK_ELEMS`` scores."""
    B, T, H, hd = q.shape
    q, k, v = (t.permute(0, 2, 1, 3).reshape(B * H, T, hd) for t in (q, k, v))
    out = torch.empty_like(q)
    g_step = max(1, min(B * H, CHUNK_ELEMS // (T * T)))
    q_step = T if T * T <= CHUNK_ELEMS else max(1, CHUNK_ELEMS // T)
    for g0 in range(0, B * H, g_step):
        kt, vg = k[g0:g0 + g_step].transpose(1, 2), v[g0:g0 + g_step]
        for q0 in range(0, T, q_step):
            w = torch.softmax(torch.bmm(q[g0:g0 + g_step, q0:q0 + q_step], kt), dim=-1)
            out[g0:g0 + g_step, q0:q0 + q_step] = torch.bmm(w, vg)
    return out.reshape(B, H, T, hd).permute(0, 2, 1, 3)


class Attention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads)`` for self-attention."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.query, self.key, self.value = (HeadDense(dim, heads) for _ in range(3))
        self.out = OutDense(dim, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query(x)
        q = q / math.sqrt(q.shape[-1])
        return self.out(attention(q, self.key(x), self.value(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.fc1 = Dense(dim, dim * mlp_ratio)
        self.fc2 = Dense(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class ViT(nn.Module):
    """ViT-S by default (dim 384, depth 12, heads 6), patch size 8, for a
    patch grid of ``grid_hw`` (the grid ``pos_embed`` was resized to)."""

    def __init__(self, patch_size: int = 8, dim: int = 384, depth: int = 12, heads: int = 6,
                 grid_hw: tuple[int, int] = (28, 28)):
        super().__init__()
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.zeros(patch_size, patch_size, 3, dim))
        self.patch_embed.bias = nn.Parameter(torch.zeros(dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid_hw[0] * grid_hw[1], dim))
        for d in range(depth):
            self.add_module(f"block{d}", ViTBlock(dim, heads))
        self.norm = LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) normalized. Returns patch tokens (B, h*w, dim)."""
        B = x.shape[0]
        p = self.patch_size
        x = F.conv2d(x.permute(0, 3, 1, 2), self.patch_embed.kernel.permute(3, 2, 0, 1),
                     self.patch_embed.bias, stride=p)
        x = x.flatten(2).transpose(1, 2)  # (B, h*w, dim), row-major patches
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), x], dim=1) + self.pos_embed
        for d in range(self.depth):
            x = getattr(self, f"block{d}")(x)
        return self.norm(x)[:, 1:]  # drop CLS


def _mask_rows(q0: int, q1: int, h: int, w: int, radius: int, device) -> torch.Tensor:
    """Rows q0:q1 of ``neighborhood_mask(h, w, radius)``."""
    q = torch.arange(q0, q1, device=device)
    s = torch.arange(h * w, device=device)
    return (((q // w)[:, None] - (s // w)[None]).abs().le(radius)
            & ((q % w)[:, None] - (s % w)[None]).abs().le(radius)).float()


def neighborhood_mask(h: int, w: int, radius: int = 12, device=None) -> torch.Tensor:
    """(h*w, h*w) 0/1 f32 mask restricting sources to a local window
    (reference ``utils/test.py:49-64``)."""
    return _mask_rows(0, h * w, h, w, radius, device)


def _row_step(n: int, h: int, w: int, radius: int) -> int:
    """Grid rows of queries a chunk: the most whose affinities against the
    band of source rows in reach (``radius`` above and below) fit
    ``CHUNK_ELEMS``."""
    rows = 1
    while rows < h and n * (rows + 1) * w * w * min(h, rows + 1 + 2 * radius) <= CHUNK_ELEMS:
        rows += 1
    return rows


def label_propagation(feat_tar: torch.Tensor, feat_sources: torch.Tensor, segs: torch.Tensor,
                      radius: int, h: int, w: int, topk: int = 5,
                      temperature: float = 0.1) -> torch.Tensor:
    """feat_tar: (h*w, C); feat_sources: (n, C, h*w); segs: (n, N, h, w).
    Returns propagated heat maps (N, h, w), as reference
    ``utils/test.py:66-101`` (JAX's takes ``neighborhood_mask(h, w,
    radius)``). Per query: the affinity to every source (n*h*w) in full f32,
    masked to the sources within ``radius`` patches, every value below the
    ``topk``-th largest zeroed (ties kept), normalized to sum 1.

    A chunk of query rows meets only the band of source rows within reach:
    the mask zeroes every other affinity, so they add nothing, and (the band
    holding at least ``topk`` of the row's values, all >= 0) the
    ``topk``-th largest is the band's. The band is all that is computed; the
    mask's rows are made per chunk."""
    n, C, hw = feat_sources.shape
    N = segs.shape[1]
    ft = feat_tar / (torch.linalg.norm(feat_tar, dim=1, keepdim=True) + 1e-12)
    fs = feat_sources / (torch.linalg.norm(feat_sources, dim=1, keepdim=True) + 1e-12)
    seg_tar = torch.empty(N, hw, dtype=segs.dtype, device=segs.device)
    rows = _row_step(n, h, w, radius)
    with full_f32_matmuls():
        for r0 in range(0, h, rows):
            q0, q1 = r0 * w, min(h, r0 + rows) * w
            b0, b1 = max(0, r0 - radius), min(h, r0 + rows + radius)  # the band's rows
            s0, s1 = b0 * w, b1 * w
            aff = torch.exp(torch.einsum("qc,ncs->nqs", ft[q0:q1], fs[:, :, s0:s1]) / temperature)
            aff = aff * _mask_rows(q0, q1, h, w, radius, ft.device)[None, :, s0:s1]
            aff = aff.transpose(0, 1).reshape(q1 - q0, n * (s1 - s0))  # (queries, sources)
            kth = torch.topk(aff, min(topk, aff.shape[1]), dim=1).values[:, -1:]
            if aff.shape[1] < topk:  # fewer band values than topk: the k-th is a 0 outside
                kth = torch.zeros_like(kth)
            aff = torch.where(aff < kth, 0.0, aff)
            aff = aff / aff.sum(dim=1, keepdim=True)
            band = segs[:, :, b0:b1].transpose(0, 1).reshape(N, n * (s1 - s0))
            seg_tar[:, q0:q1] = band @ aff.t()
    return seg_tar.reshape(N, h, w)


def soft_argmax_xy(heat: torch.Tensor) -> torch.Tensor:
    """(N, H, W) nonneg heat maps -> (N, 2) xy weighted-average coords."""
    N, H, W = heat.shape
    total = heat.sum(dim=(1, 2))
    ys = torch.arange(H, dtype=torch.float32, device=heat.device)
    xs = torch.arange(W, dtype=torch.float32, device=heat.device)
    cy = (heat.sum(2) @ ys) / (total + 1e-12)
    cx = (heat.sum(1) @ xs) / (total + 1e-12)
    return torch.stack([cx, cy], dim=1)


def norm_heat(heat: torch.Tensor) -> torch.Tensor:
    """Per-channel min-max normalize where max > 0 (``utils/test.py:103-111``)."""
    N = heat.shape[0]
    flat = heat.reshape(N, -1)
    mn = flat.min(dim=1).values.reshape(N, 1, 1)
    mx = flat.max(dim=1).values.reshape(N, 1, 1)
    normed = (heat - mn) / torch.where(mx - mn > 0, mx - mn, torch.ones_like(mx))
    return torch.where(mx > 0, normed, heat)


class DinoTracker:
    """Keypoint tracking by label propagation over ViT features (reference
    ``utils/test.py:114-194``). The features, heat maps and trajectories stay
    on ``device`` (CUDA unless ``device="cpu"``) until ``track`` returns."""

    def __init__(self, feat_fn: Callable[[torch.Tensor], torch.Tensor], patch_size: int = 8,
                 n_last_frames: int = 7, neighborhood: int = 12, device="cuda"):
        """feat_fn: (S, H, W, 3) raw [0, 255] f32 frames on ``device`` ->
        (S, h, w, C) features."""
        self.feat_fn = feat_fn
        self.patch_size = patch_size
        self.n_last_frames = n_last_frames
        self.neighborhood = neighborhood
        self.device = resolve_device(device)

    @staticmethod
    def make_vit_feat_fn(variables, patch_size: int = 8, dim: int = 384, depth: int = 12,
                         heads: int = 6, device="cuda"):
        """A ``ViT`` loaded from ``variables`` (flax layout; its ``pos_embed``
        sets the patch grid) on ``device``, and the feat_fn that runs it."""
        n_pos = np.asarray(variables["params"]["pos_embed"]).shape[1] - 1
        model = ViT(patch_size, dim, depth, heads, grid_hw=(1, n_pos))
        model = load_flax_params(model, variables).to(resolve_device(device)).eval()
        mean = torch.from_numpy(IMAGENET_MEAN).to(device)
        std = torch.from_numpy(IMAGENET_STD).to(device)

        def feat_fn(rgbs: torch.Tensor) -> torch.Tensor:
            S, H, W, _ = rgbs.shape
            with torch.inference_mode():
                tokens = model((rgbs / 255.0 - mean) / std)
            return tokens.reshape(S, H // patch_size, W // patch_size, -1)

        return feat_fn

    def track(self, rgbs: np.ndarray, xy0: np.ndarray, prev_fallback: bool = True) -> np.ndarray:
        """rgbs: (S, H, W, 3) [0, 255]; xy0: (N, 2). Returns trajs (S, N, 2) numpy."""
        S = rgbs.shape[0]
        N = xy0.shape[0]
        p = self.patch_size
        with torch.inference_mode():
            featmaps = self.feat_fn(torch.from_numpy(np.asarray(rgbs, np.float32)).to(self.device))
            _, h, w, C = featmaps.shape
            feats = featmaps.reshape(S, h * w, C)

            first_seg = np.zeros((N, h, w), np.float32)
            for i in range(N):  # numpy indexing, as JAX's tracker does
                first_seg[i, int(xy0[i, 1] // p), int(xy0[i, 0] // p)] = 1

            trajs = torch.zeros(S, N, 2, device=self.device)
            trajs[0] = torch.from_numpy(np.asarray(xy0, np.float32)).to(self.device)
            queue: list[tuple[torch.Tensor, torch.Tensor]] = []
            frame1 = (feats[0], torch.from_numpy(first_seg).to(self.device))
            for s in range(1, S):
                sources = [frame1] + queue
                feat_sources = torch.stack([f.t() for f, _ in sources])
                segs = torch.stack([sg for _, sg in sources])
                seg_tar = label_propagation(feats[s], feat_sources, segs, self.neighborhood,
                                            h, w)
                if len(queue) == self.n_last_frames:
                    queue.pop(0)
                queue.append((feats[s], seg_tar))

                # upsample to pixels (half-pixel bilinear), normalize, soft-argmax
                with full_f32_matmuls():
                    up = norm_heat(resize_half_pixel(seg_tar, (h * p, w * p), "linear"))
                    xy = soft_argmax_xy(up)
                if prev_fallback:
                    empty = up.sum(dim=(1, 2)) <= 0
                    xy = torch.where(empty[:, None], trajs[s - 1], xy)
                trajs[s] = xy
            return trajs.cpu().numpy()
