from sliders_tpu_torch.diffusion.schedulers import (  # noqa: F401
    DiffusionSchedule,
    Sampler,
    make_sampler,
    make_schedule,
)
