from pips_tpu_torch.models.encoder import BasicEncoder
from pips_tpu_torch.models.mixer import DeltaBlock, MLPMixer
from pips_tpu_torch.models.pips import Pips, PipsOutput, init_params, make_pips
from pips_tpu_torch.models.pips2 import Pips2, TemporalBlock, TemporalRefiner

__all__ = ["BasicEncoder", "DeltaBlock", "MLPMixer", "Pips", "Pips2", "PipsOutput",
           "TemporalBlock", "TemporalRefiner", "init_params", "make_pips"]
