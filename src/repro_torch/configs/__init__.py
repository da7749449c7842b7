"""Architecture configs of the LM stack (``--arch <id>``).  Importing this
package registers them.

The port runs the dense attention family: the four configs below.  The
MoE, MLA, mamba-hybrid, rwkv and modality configs of the reference package
arrive with the rest of its LM stack (roadmap item A13).
"""

from .base import (ArchConfig, MLAConfig, MoEConfig, SHAPES, ShapeSpec,
                   SSMConfig, get_config, list_configs, register)

# Register every config the port runs (one module per arch).
from . import starcoder2_15b  # noqa: F401
from . import minitron_8b  # noqa: F401
from . import qwen2_0_5b  # noqa: F401
from . import qwen1_5_32b  # noqa: F401

ARCH_IDS = ("starcoder2-15b", "minitron-8b", "qwen2-0.5b", "qwen1.5-32b")

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "SHAPES",
           "ShapeSpec", "get_config", "list_configs", "register", "ARCH_IDS"]
