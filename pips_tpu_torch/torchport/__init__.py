"""Readers of the reference PyTorch checkpoints: PIPs, RAFT and DINO's ViT
(counterpart of ``pips_tpu/torchport``)."""

from pips_tpu_torch.torchport.convert import (convert_dino_vit_state_dict, convert_pips_state_dict,
                                              convert_raft_state_dict, load_torch_checkpoint)

__all__ = ["convert_dino_vit_state_dict", "convert_pips_state_dict", "convert_raft_state_dict",
           "load_torch_checkpoint"]
