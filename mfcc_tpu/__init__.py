"""mfcc_tpu — a speech feature-extraction framework on JAX, run on GPUs.

A from-scratch JAX/XLA re-imagining of the capabilities surveyed in
SURVEY.md: the full MFCC front-end (framing/windowing, GEMM-native real
DFT/STFT, mel filterbank, log compression, DCT-II cepstra) plus ragged
batching, streaming, and multi-device data parallelism with global CMVN.

Quick start::

    import numpy as np
    from mfcc_tpu import FeatureConfig, models

    cfg = FeatureConfig()                   # 16 kHz, 25 ms / 10 ms, MFCC-13
    x = np.random.randn(16000).astype(np.float32)
    feats = models.mfcc.mfcc_jit(x, cfg)    # (98, 13)
"""

from .config import (FeatureConfig, PitchConfig, MFCC13,  # noqa: F401
                     LOGMEL80, logmel_config)
from . import oracle, ops, models, dataset  # noqa: F401

__version__ = "0.1.0"
