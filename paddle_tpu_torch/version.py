"""Version info for paddle_tpu_torch (counterpart of
``paddle_tpu/version.py``)."""

full_version = "0.1.0"
major = 0
minor = 1
patch = 0


def show() -> str:
    return full_version
