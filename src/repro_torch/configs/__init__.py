"""Architecture configs of the LM stack (``--arch <id>``).  Importing this
package registers them.

The port runs the ``"attn"`` block pattern: dense, MoE (grok-1), MLA with
MoE (deepseek-v3), and the vision and audio front ends (llava-next,
hubert).  The reference's two recurrent configs, ``zamba2-7b``
(mamba-hybrid) and ``rwkv6-1.6b`` (rwkv), arrive with the rest of its LM
stack (roadmap item A13).
"""

from .base import (ArchConfig, MLAConfig, MoEConfig, SHAPES, ShapeSpec,
                   SSMConfig, get_config, list_configs, register)

# Register every config the port runs (one module per arch).
from . import starcoder2_15b  # noqa: F401
from . import minitron_8b  # noqa: F401
from . import qwen2_0_5b  # noqa: F401
from . import qwen1_5_32b  # noqa: F401
from . import grok_1_314b  # noqa: F401
from . import deepseek_v3_671b  # noqa: F401
from . import llava_next_mistral_7b  # noqa: F401
from . import hubert_xlarge  # noqa: F401

# the reference's ids in its order, less zamba2-7b and rwkv6-1.6b
ARCH_IDS = (
    "starcoder2-15b", "minitron-8b", "qwen2-0.5b", "qwen1.5-32b",
    "grok-1-314b", "deepseek-v3-671b", "llava-next-mistral-7b",
    "hubert-xlarge",
)

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "SHAPES",
           "ShapeSpec", "get_config", "list_configs", "register", "ARCH_IDS"]
