"""Core data model and configuration of the PyTorch/CUDA port."""

from llmq_tpu_torch.core.config import Config, load_config
from llmq_tpu_torch.core.types import Message, MessageStatus, Priority

__all__ = ["Config", "Message", "MessageStatus", "Priority", "load_config"]
