"""Offline FlyingThings -> FlyingThings++ dataset generation (counterpart
of ``pips_tpu/datagen``; capability parity: reference ``make_trajs.py``,
``filter_trajs.py``, ``make_occlusions.py``). Host-side numpy tools.

    python -m pips_tpu_torch.datagen.run --what trajs --flt3d_path <flyingthings>
"""

from pips_tpu_torch.datagen.trajs import chain_flow_trajs, filter_trajs
from pips_tpu_torch.datagen.occluders import consider_id, flood_fill_hull

__all__ = ["chain_flow_trajs", "consider_id", "filter_trajs", "flood_fill_hull"]
