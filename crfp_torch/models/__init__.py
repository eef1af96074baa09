"""Model configuration and the runtime (streaming) models."""
