"""Checkpoints: serving transcripts and training trees."""
from repro_torch.checkpoint.store import (CheckpointStore, TranscriptSnapshot,
                                          load_transcripts, save_transcripts)

__all__ = ["CheckpointStore", "TranscriptSnapshot", "save_transcripts",
           "load_transcripts"]
