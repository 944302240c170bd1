"""RAFT optical-flow baseline (counterpart of ``pips_tpu/models/raft.py``),
eval only, f32.

Capability parity with the reference's vendored RAFT (``nets/raft_core/``;
wrapper ``nets/raftnet.py``): feature and context encoders, the all-pairs
correlation pyramid (4 levels, radius 4), SepConvGRU updates and convex
upsampling. The eval runners chain its flows into trajectories
(``inference/flow_chain.py``).

The API is the JAX package's: frames (B, H, W, 3) and flows (B, H, W, 2),
channel-last. Inside, the convolutions index NCHW (``F.conv2d``) on
channels_last memory (the frames' permute), which cuDNN's f32 convs run
faster than NCHW-contiguous tensors on the H100. The module
tree mirrors the flax tree, so ``pips_tpu_torch.convert.load_flax_params``
loads ``torchport.convert_raft_state_dict``'s output leaf for leaf:
``models.encoder.Conv`` stands for JAX's ``Conv`` (``<name>.weight``), the
GRU's bare ``nn.Conv`` layers keep flax's ``kernel`` (kh, kw, I, O), and the
batch norms hold their running statistics as the buffers ``mean`` and ``var``.
No kernel of the port runs here: JAX's RAFT reaches no Pallas kernel either;
the all-pairs product is one ``torch.matmul``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pips_tpu_torch.models.encoder import Conv, instance_norm
from pips_tpu_torch.models.pips import resolve_device
from pips_tpu_torch.ops.grids import coords_grid
from pips_tpu_torch.ops.resize import avg_pool2x2


class BatchNormInference(nn.Module):
    """BatchNorm2d in eval mode on NCHW x: the running statistics are the
    buffers ``mean`` and ``var`` (flax's ``batch_stats``), eps 1e-5."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def c(t):
            return t[None, :, None, None]
        return (x - c(self.mean)) * torch.rsqrt(c(self.var) + 1e-5) * c(self.scale) + c(self.bias)


class FlaxConv(nn.Module):
    """flax ``nn.Conv`` with explicit symmetric padding, its kernel kept in
    flax's (kh, kw, I, O) layout under the name ``kernel``."""

    def __init__(self, c_in: int, c_out: int, kh: int, kw: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kh, kw, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, padding=(kh // 2, kw // 2))


class RaftResidualBlock(nn.Module):
    def __init__(self, c_in: int, planes: int, norm: str = "instance", stride: int = 1):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv(c_in, planes, 3, stride, 1)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.downsample = Conv(c_in, planes, 1, stride, 0) if stride != 1 else None
        if norm == "batch":
            self.norm1 = BatchNormInference(planes)
            self.norm2 = BatchNormInference(planes)
            if stride != 1:
                self.norm3 = BatchNormInference(planes)

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.norm == "instance":
            return instance_norm(x)
        if self.norm == "batch":
            return getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self._norm(self.conv1(x), "norm1"))
        y = F.relu(self._norm(self.conv2(y), "norm2"))
        if self.downsample is not None:
            x = self._norm(self.downsample(x), "norm3")
        return F.relu(x + y)


class RaftEncoder(nn.Module):
    """RAFT BasicEncoder: (B, 3, H, W) -> (B, output_dim, H/8, W/8)."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv(3, 64, 7, 2, 3)
        if norm == "batch":
            self.norm1 = BatchNormInference(64)
        c_in = 64
        for i, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)]):
            self.add_module(f"layer{i + 1}_0", RaftResidualBlock(c_in, dim, norm, stride))
            self.add_module(f"layer{i + 1}_1", RaftResidualBlock(dim, dim, norm, 1))
            c_in = dim
        self.conv2 = Conv(128, output_dim, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        if self.norm == "instance":
            x = instance_norm(x)
        elif self.norm == "batch":
            x = self.norm1(x)
        x = F.relu(x)
        for i in range(3):
            x = getattr(self, f"layer{i + 1}_1")(getattr(self, f"layer{i + 1}_0")(x))
        return self.conv2(x)


def allpairs_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          num_levels: int = 4) -> list[torch.Tensor]:
    """fmap1/2: (B, C, H, W) -> per level (B*H*W, h_l, w_l, 1) corr volumes."""
    B, C, H, W = fmap1.shape
    f1 = fmap1.reshape(B, C, H * W).transpose(1, 2)
    corr = torch.matmul(f1, fmap2.reshape(B, C, H * W)) / math.sqrt(C)
    corr = corr.reshape(B * H * W, H, W, 1)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool2x2(corr)
        pyramid.append(corr)
    return pyramid


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """coords: (B, H, W, 2) current matches at 1/8 scale, xy.

    Returns (B, H, W, L*(2r+1)^2): patch[i, j] samples (x + o_i, y + o_j),
    flattened i-major, as the reference (``corr.py:45-49``) orders it. Each
    query gathers its (2r+2)^2 integer taps from its own row of the volume
    (int64 indices, one per tap), then blends them with its shared
    fractional offset; taps off the map read zero.
    """
    B, H, W, _ = coords.shape
    r = radius
    P = 2 * r + 1
    G = P + 1
    a = torch.arange(G, device=coords.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        h, w = corr.shape[1], corr.shape[2]
        c = coords.reshape(B * H * W, 2) / (2.0 ** lvl)
        x, y = c[:, 0], c[:, 1]
        x0f, y0f = torch.floor(x), torch.floor(y)
        wx = (x - x0f)[:, None, None]
        wy = (y - y0f)[:, None, None]
        yy = y0f.long()[:, None] - r + a  # (BHW, G)
        xx = x0f.long()[:, None] - r + a
        valid = ((yy[:, :, None] >= 0) & (yy[:, :, None] <= h - 1)
                 & (xx[:, None, :] >= 0) & (xx[:, None, :] <= w - 1))
        flat = (yy.clamp(0, h - 1)[:, :, None] * w
                + xx.clamp(0, w - 1)[:, None, :]).reshape(B * H * W, G * G)
        vol = corr.reshape(B * H * W, h * w)
        g = torch.gather(vol, 1, flat).reshape(B * H * W, G, G)
        g = g * valid.to(g.dtype)
        interp = ((1 - wy) * (1 - wx) * g[:, 0:P, 0:P]
                  + (1 - wy) * wx * g[:, 0:P, 1:G]
                  + wy * (1 - wx) * g[:, 1:G, 0:P]
                  + wy * wx * g[:, 1:G, 1:G])  # indexed [j, i]
        interp = interp.transpose(-1, -2)  # the reference's order: [i, j]
        out.append(interp.reshape(B, H, W, P * P))
    return torch.cat(out, dim=-1)


class BasicMotionEncoder(nn.Module):
    """(flow, corr) NCHW -> 128 motion channels (126 + the flow)."""

    def __init__(self, corr_planes: int = 4 * 81):
        super().__init__()
        self.convc1 = Conv(corr_planes, 256, 1, 1, 0)
        self.convc2 = Conv(256, 192, 3, 1, 1)
        self.convf1 = Conv(2, 128, 7, 1, 3)
        self.convf2 = Conv(128, 64, 3, 1, 1)
        self.conv = Conv(192 + 64, 126, 3, 1, 1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """Separable (1x5 then 5x1) ConvGRU."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        for suffix, (kh, kw) in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{suffix}",
                                FlaxConv(hidden + input_dim, hidden, kh, kw))

    def _gru(self, h: torch.Tensor, x: torch.Tensor, suffix: str) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
        q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._gru(self._gru(h, x, "1"), x, "2")


class FlowHead(nn.Module):
    def __init__(self, c_in: int = 128):
        super().__init__()
        self.conv1 = Conv(c_in, 256, 3, 1, 1)
        self.conv2 = Conv(256, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """(net, inp, corr, flow) NCHW -> (net, mask, delta_flow)."""

    def __init__(self, hidden: int = 128, context: int = 128, corr_planes: int = 4 * 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, context + 128)
        self.flow_head = FlowHead(hidden)
        self.mask1 = Conv(hidden, 256, 3, 1, 1)
        self.mask2 = Conv(256, 64 * 9, 1, 1, 0)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        mask = self.mask2(F.relu(self.mask1(net))) * 0.25
        return net, mask, delta


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling, as JAX's ``convex_upsample``.

    flow: (B, H, W, 2) at 1/8; mask: (B, H, W, 64*9), its channels (i, j, n)
    row-major. Returns (B, 8H, 8W, 2)."""
    B, H, W, _ = flow.shape
    m = torch.softmax(mask.reshape(B, H, W, 8, 8, 9), dim=-1)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))  # zeros, as unfold with padding=1
    neigh = torch.stack([fp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
                        dim=-2)  # (B, H, W, 9, 2)
    up = torch.einsum("bhwijn,bhwnc->bhwijc", m, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * H, 8 * W, 2)


class RAFT(nn.Module):
    """Full RAFT, eval mode: images (B, H, W, 3) in [0, 255], H and W
    multiples of 8 -> (flow_low (B, H/8, W/8, 2), flow_up (B, H, W, 2))."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 4):
        super().__init__()
        self.hidden_dim, self.corr_levels, self.corr_radius = hidden_dim, corr_levels, corr_radius
        self.fnet = RaftEncoder(256, "instance")
        self.cnet = RaftEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim, context_dim,
                                             corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 20):
        def prep(im):
            return (2.0 * (im / 255.0) - 1.0).permute(0, 3, 1, 2)

        image1, image2 = prep(image1), prep(image2)
        fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        pyramid = allpairs_corr_pyramid(fmap1, fmap2, self.corr_levels)
        del fmap2
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim:])

        B, _, H8, W8 = fmap1.shape
        coords0 = coords_grid(B, H8, W8, device=fmap1.device)
        coords1 = coords0
        flow_up = None
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_lookup(pyramid, coords1, self.corr_radius).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
            flow_up = convex_upsample(coords1 - coords0, mask.permute(0, 2, 3, 1))
        return coords1 - coords0, flow_up


class Raftnet:
    """Eval wrapper (reference ``nets/raftnet.py``): frames in [-0.5, 0.5],
    edge-replicated to multiples of 8 and cropped back. ``model`` is a loaded
    ``RAFT``; it is moved to ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, model: RAFT, iters: int = 20, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.iters = iters

    def forward(self, image1, image2) -> torch.Tensor:
        """image1/2: (B, H, W, 3) in [-0.5, 0.5], numpy or tensors. Returns
        flow_up (B, H, W, 2), a tensor on the model's device."""
        def prep(im):
            im = (torch.as_tensor(im, dtype=torch.float32, device=self.device) + 0.5) * 255.0
            if pad_h or pad_w:  # edge replication, as InputPadder (``util.py:7-27``)
                im = F.pad(im.permute(0, 3, 1, 2), (pad_w // 2, pad_w - pad_w // 2,
                                                    pad_h // 2, pad_h - pad_h // 2),
                           mode="replicate").permute(0, 2, 3, 1)
            return im

        H, W = image1.shape[1:3]
        pad_h, pad_w = (-H) % 8, (-W) % 8
        with torch.inference_mode():
            _, flow_up = self.model(prep(image1), prep(image2), iters=self.iters)
        return flow_up[:, pad_h // 2:pad_h // 2 + H, pad_w // 2:pad_w // 2 + W]
