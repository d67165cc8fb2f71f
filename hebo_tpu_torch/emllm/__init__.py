"""EM-LLM's episodic memory on the port (``hebo_tpu/emllm``): surprise
segmentation, two-stage retrieval and masked attention.  ``EMLLMRunner``
(``hf_integration``) needs ``transformers`` and is not imported here."""

from .attention import EMLLMAttention, masked_attention
from .memory import EpisodicKVMemory, retrieve_sharded
from .segmentation import refine_boundaries, segment_events, surprise_boundaries
