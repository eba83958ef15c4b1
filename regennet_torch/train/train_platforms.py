"""Scalar-reporting backends of the training loop (the port's copy of
regennet_tpu/train/train_platforms.py): `NoPlatform`, and
`TensorboardPlatform`, which writes event files into the run's directory
(torch.utils.tensorboard, imported when the platform is built).
ClearmlPlatform is known but not ported: `clearml` is not a dependency."""


class TrainPlatform:
    def __init__(self, save_dir):
        pass

    def report_scalar(self, name, value, iteration, group_name=None):
        pass

    def report_args(self, args, name):
        pass

    def close(self):
        pass


class NoPlatform(TrainPlatform):
    pass


class TensorboardPlatform(TrainPlatform):
    def __init__(self, save_dir):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=save_dir)

    def report_scalar(self, name, value, iteration, group_name=None):
        self.writer.add_scalar(f"{group_name}/{name}", value, iteration)

    def close(self):
        self.writer.close()


PLATFORM_REGISTRY = {"NoPlatform": NoPlatform, "TensorboardPlatform": TensorboardPlatform}
KNOWN_PLATFORMS = ("NoPlatform", "ClearmlPlatform", "TensorboardPlatform")


def get_platform(name: str):
    if name in PLATFORM_REGISTRY:
        return PLATFORM_REGISTRY[name]
    if name in KNOWN_PLATFORMS:
        raise NotImplementedError(f"train platform {name!r} is not ported")
    raise KeyError(name)
