from lightly_train_tpu_torch._debug.nan_guard import NaNGuard
from lightly_train_tpu_torch._debug.replay import replay_nan_capture

__all__ = ["NaNGuard", "replay_nan_capture"]
