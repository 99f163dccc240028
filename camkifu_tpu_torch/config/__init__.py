"""The port's own copy of the vision and board constants it reads."""

from camkifu_tpu_torch.config import cvconf, guiconf  # noqa: F401
