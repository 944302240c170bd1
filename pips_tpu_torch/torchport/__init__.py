"""Readers of the reference PyTorch PIPs checkpoints (counterpart of
``pips_tpu/torchport``)."""

from pips_tpu_torch.torchport.convert import convert_pips_state_dict, load_torch_checkpoint

__all__ = ["convert_pips_state_dict", "load_torch_checkpoint"]
