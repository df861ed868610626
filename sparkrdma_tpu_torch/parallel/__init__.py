from sparkrdma_tpu_torch.parallel.device import resolve_device, select_devices

__all__ = ["resolve_device", "select_devices"]
