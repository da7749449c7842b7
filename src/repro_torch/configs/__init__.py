"""Architecture configs of the LM stack (``--arch <id>``).  Importing this
package registers them.

All ten of the reference's: dense, MoE (grok-1), MLA with MoE
(deepseek-v3), the vision and audio front ends (llava-next, hubert), the
Mamba2 hybrid (zamba2) and RWKV-6.  ``embml_classifiers`` is the paper's
own classifier suite, not an LM architecture.
"""

from .base import (ArchConfig, MLAConfig, MoEConfig, SHAPES, ShapeSpec,
                   SharedBlockConfig, SSMConfig, Zamba2ArchConfig, get_config,
                   list_configs, register)

# Register every config the port runs (one module per arch).
from . import starcoder2_15b  # noqa: F401
from . import minitron_8b  # noqa: F401
from . import qwen2_0_5b  # noqa: F401
from . import qwen1_5_32b  # noqa: F401
from . import grok_1_314b  # noqa: F401
from . import deepseek_v3_671b  # noqa: F401
from . import zamba2_7b  # noqa: F401
from . import zamba2_7b_hf  # noqa: F401  (the published block; not an ARCH_ID)
from . import llava_next_mistral_7b  # noqa: F401
from . import rwkv6_1_6b  # noqa: F401
from . import hubert_xlarge  # noqa: F401
from . import embml_classifiers  # noqa: F401  (the paper's own model zoo)

# the reference's ids, in its order
ARCH_IDS = (
    "starcoder2-15b", "minitron-8b", "qwen2-0.5b", "qwen1.5-32b",
    "grok-1-314b", "deepseek-v3-671b", "zamba2-7b",
    "llava-next-mistral-7b", "rwkv6-1.6b", "hubert-xlarge",
)

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "SharedBlockConfig", "Zamba2ArchConfig", "SHAPES",
           "ShapeSpec", "get_config", "list_configs", "register", "ARCH_IDS"]
