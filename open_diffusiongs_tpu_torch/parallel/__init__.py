"""The one-GPU train step: optimizer, clipping, accumulation, EMA."""
