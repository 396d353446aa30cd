"""The LoRA composability study."""
