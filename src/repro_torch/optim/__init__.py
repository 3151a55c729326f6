from repro_torch.optim.optimizers import AdamWConfig, AdamWState, adamw_update, init_adamw

__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "init_adamw"]
