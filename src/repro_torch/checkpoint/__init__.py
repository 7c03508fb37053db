"""Serving checkpoints (request transcripts)."""
from repro_torch.checkpoint.store import (TranscriptSnapshot, load_transcripts,
                                          save_transcripts)

__all__ = ["TranscriptSnapshot", "save_transcripts", "load_transcripts"]
