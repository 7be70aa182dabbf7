"""reazonspeech_tpu_torch.espnet.oneseg — alias of reazonspeech_tpu_torch.oneseg,
kept at the reference's import path (pkg/espnet-oneseg installs
reazonspeech.espnet.oneseg). A copy of ``reazonspeech_tpu/espnet/oneseg``."""

from ...oneseg import *  # noqa: F401,F403
from ...oneseg import __all__  # noqa: F401
