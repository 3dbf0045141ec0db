from videosd_tpu_torch.schedulers.lcm import (
    LCMSchedulerConfig,
    add_noise,
    boundary_scalings,
    make_alphas_cumprod,
    step,
    timestep_schedule,
)

__all__ = [
    "LCMSchedulerConfig",
    "add_noise",
    "boundary_scalings",
    "make_alphas_cumprod",
    "step",
    "timestep_schedule",
]
