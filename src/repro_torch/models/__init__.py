"""The LM scaffold's model zoo (the port of ``repro.models``): one assembly
(``transformer``) covering dense GQA, MoE, MLA+MTP, SSD (Mamba2), hybrid
(Zamba2), enc-dec (Whisper) and VLM-stub families."""
from repro_torch.models import attention, common, mlp, ssm, transformer  # noqa: F401
from repro_torch.models.common import ModelConfig  # noqa: F401
