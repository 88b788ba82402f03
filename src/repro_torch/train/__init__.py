"""Training: the train steps, checkpoints and the Trainer.
Reference: ``src/repro/train/``."""
