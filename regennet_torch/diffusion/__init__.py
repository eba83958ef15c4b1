from regennet_torch.diffusion.schedule import (  # noqa: F401
    DiffusionConfig,
    Schedule,
    get_named_beta_schedule,
    make_schedule,
    space_timesteps,
)
