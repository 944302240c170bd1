"""A frozen copy of ``pips_tpu_torch/data/synthetic.py`` at commit 58c35d9,
kept with the benchmark so that a later change to the program's data module
cannot move the yardstick. The class body is unchanged; only this docstring
differs from the original, whose own follows.

Synthetic point-tracking data: textured sprites translating over a textured
background, with exact ground-truth trajectories, visibility (sprite-on-top +
in-bounds), and valids. A copy of ``pips_tpu/data/synthetic.py`` (numpy only),
so the port needs nothing of the JAX package.

This is the framework's built-in smoke/e2e dataset — the reference has no
equivalent (its only quick mode is ``train2.py --quick``); it lets the full
train/eval stack run and overfit without the FlyingThings++ archives.

Sample dict layout matches the train pipeline (reference
``flyingthingsdataset.py:406-433``): rgbs (S,H,W,3) float 0..255,
trajs (S,N,2) xy, visibles (S,N), valids (S,N).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticPointDataset:
    def __init__(self, S: int = 8, N: int = 64, H: int = 128, W: int = 192,
                 num_sprites: int = 4, sprite_size: int = 24, max_vel: float = 6.0,
                 seed: int = 125):
        self.S, self.N, self.H, self.W = S, N, H, W
        self.num_sprites = num_sprites
        self.sprite_size = sprite_size
        self.max_vel = max_vel
        self.seed = seed

    def __len__(self) -> int:
        return 1 << 30

    def _texture(self, rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
        """Smooth random RGB texture (coarse noise, bilinearly upsampled)."""
        coarse = rng.rand(max(h // 8, 2), max(w // 8, 2), 3)
        ys = np.linspace(0, coarse.shape[0] - 1, h)
        xs = np.linspace(0, coarse.shape[1] - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, coarse.shape[0] - 1)
        x1 = np.minimum(x0 + 1, coarse.shape[1] - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        tex = ((1 - wy) * (1 - wx) * coarse[y0][:, x0]
               + (1 - wy) * wx * coarse[y0][:, x1]
               + wy * (1 - wx) * coarse[y1][:, x0]
               + wy * wx * coarse[y1][:, x1])
        return (tex * 255.0).astype(np.float32)

    def __getitem__(self, idx: int) -> tuple[Dict[str, np.ndarray], bool]:
        rng = np.random.RandomState((self.seed + idx) % (1 << 31))
        S, N, H, W = self.S, self.N, self.H, self.W
        ss = self.sprite_size

        bg = self._texture(rng, H, W)
        sprites = []
        for _ in range(self.num_sprites):
            tex = self._texture(rng, ss, ss)
            pos0 = rng.rand(2) * [W - ss, H - ss]
            vel = (rng.rand(2) * 2 - 1) * self.max_vel
            sprites.append((tex, pos0, vel))

        rgbs = np.empty((S, H, W, 3), np.float32)
        occ_of = np.full((S, H, W), -1, np.int32)  # topmost sprite id per pixel
        for s in range(S):
            frame = bg.copy()
            for k, (tex, pos0, vel) in enumerate(sprites):
                x0, y0 = np.round(pos0 + vel * s).astype(int)
                xa, xb = np.clip([x0, x0 + ss], 0, W)
                ya, yb = np.clip([y0, y0 + ss], 0, H)
                if xb <= xa or yb <= ya:
                    continue
                frame[ya:yb, xa:xb] = tex[ya - y0:yb - y0, xa - x0:xb - x0]
                occ_of[s, ya:yb, xa:xb] = k
            rgbs[s] = frame

        # query points: some on sprites (track the sprite), some on background
        trajs = np.empty((S, N, 2), np.float32)
        vis = np.ones((S, N), np.float32)
        owner = np.full(N, -1, np.int32)
        n_sprite = N // 2
        for n in range(N):
            if n < n_sprite:
                k = rng.randint(self.num_sprites)
                tex, pos0, vel = sprites[k]
                off = rng.rand(2) * (ss - 4) + 2
                owner[n] = k
                for s in range(S):
                    trajs[s, n] = pos0 + vel * s + off
            else:
                p = rng.rand(2) * [W - 1, H - 1]
                trajs[:, n] = p
        # visibility: in-bounds and (for bg points / lower sprites) not covered
        for s in range(S):
            for n in range(N):
                x, y = trajs[s, n]
                if not (0 <= x <= W - 1 and 0 <= y <= H - 1):
                    vis[s, n] = 0
                    continue
                top = occ_of[s, int(round(np.clip(y, 0, H - 1))), int(round(np.clip(x, 0, W - 1)))]
                if top != owner[n]:
                    vis[s, n] = 0

        valids = np.ones((S, N), np.float32)
        sample = {"rgbs": rgbs, "trajs": trajs, "visibles": vis, "valids": valids}
        return sample, True
