"""The config dataclasses, shared with the JAX package.

``gdrnpp_bop2022_tpu.config`` imports nothing but the standard library, so
both packages read one definition of ``Config()`` and its overrides.
"""

from gdrnpp_bop2022_tpu.config import *  # noqa: F401,F403
from gdrnpp_bop2022_tpu.config import (Config, PoseNetConfig,  # noqa: F401
                                       parse_opts, replace_cfg)
