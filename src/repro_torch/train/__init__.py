"""LM training: AdamW (`optim`), checkpoints (`checkpoint`), fault
injection and recovery (`fault`) and the `Trainer` loop (`loop`)."""
