"""Short import alias for the PyTorch port of the LoRA-robustness framework.

``import apvt_lora_torch`` is equivalent to importing
``adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch``;
both names resolve to the same module object so submodule imports work under
either prefix.
"""

import sys as _sys

import adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch as _pkg

_sys.modules[__name__] = _pkg
