from repro_torch.power.model import HardwareModel, H100_DGX, accelerator_power

__all__ = ["HardwareModel", "H100_DGX", "accelerator_power"]
