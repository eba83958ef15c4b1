"""Scalar-reporting backends of the training loop (the port's copy of
regennet_tpu/train/train_platforms.py): `NoPlatform` only; the other
platform names are known but not ported."""


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


PLATFORM_REGISTRY = {"NoPlatform": NoPlatform}
KNOWN_PLATFORMS = ("NoPlatform", "ClearmlPlatform", "TensorboardPlatform")


def get_platform(name: str):
    if name in PLATFORM_REGISTRY:
        return PLATFORM_REGISTRY[name]
    if name in KNOWN_PLATFORMS:
        raise NotImplementedError(f"train platform {name!r} is not ported")
    raise KeyError(name)
