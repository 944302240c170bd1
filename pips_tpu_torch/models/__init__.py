from pips_tpu_torch.models.encoder import BasicEncoder
from pips_tpu_torch.models.mixer import DeltaBlock, MLPMixer
from pips_tpu_torch.models.pips import Pips, PipsOutput, init_params, make_pips

__all__ = ["BasicEncoder", "DeltaBlock", "MLPMixer", "Pips", "PipsOutput", "init_params",
           "make_pips"]
