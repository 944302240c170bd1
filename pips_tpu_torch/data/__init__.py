"""Data (counterpart of ``pips_tpu/data``): the synthetic point-tracking set,
the FlyingThings++ and PointOdyssey training sets, the BADJA and CroHD
evaluation readers, the host batcher and the CUDA prefetcher."""

from pips_tpu_torch.data.badja import BadjaDataset
from pips_tpu_torch.data.crohd import CrohdDataset
from pips_tpu_torch.data.flyingthings import FlyingThingsDataset
from pips_tpu_torch.data.loader import DevicePrefetcher, batch_iterator
from pips_tpu_torch.data.pointodyssey import PointOdysseyDataset
from pips_tpu_torch.data.synthetic import SyntheticPointDataset

__all__ = ["BadjaDataset", "CrohdDataset", "DevicePrefetcher", "FlyingThingsDataset",
           "PointOdysseyDataset", "SyntheticPointDataset", "batch_iterator"]
