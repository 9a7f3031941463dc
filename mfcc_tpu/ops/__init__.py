"""Compute stages of the MFCC front-end.

Stage map (the analog of the reference compiler's lex -> parse -> codegen
pipeline, ``/root/reference/src/mfcc/main.c:72-107``):

- :mod:`framing`  — PCM -> pre-emphasized overlapping frames (the "lexer")
- :mod:`spectrum` — frames -> power spectra via GEMM-native real DFT (the
  "parser")
- :mod:`mel` / :mod:`dct` — spectra -> log-mel -> cepstra projections (the
  "code generator")
- :mod:`deltas`   — time-derivative appends
- :mod:`resample` — rational sample-rate conversion as one polyphase GEMM
- :mod:`augment`  — SpecAugment time/frequency masking (training-time)
"""

from . import framing, spectrum, mel, dct, deltas  # noqa: F401
from . import resample, augment  # noqa: F401
