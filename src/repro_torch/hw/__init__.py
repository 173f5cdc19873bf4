from repro_torch.hw.core_model import CoreModel, cacti_like_energy_pj_per_bit
from repro_torch.hw.accelerator import Accelerator

__all__ = ["CoreModel", "Accelerator", "cacti_like_energy_pj_per_bit"]
