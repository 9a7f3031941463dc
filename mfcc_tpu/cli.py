"""Command-line driver: ``python -m mfcc_tpu <wav|dir|list.txt>``.

The fixed-pipeline CLI in the spirit of the reference's ``./mfcc <file.c>``
(``/root/reference/src/mfcc/main.c:47-60``) — but with a real flag surface
(the reference hardcodes its output path, target, and debug dump; SURVEY.md
§5 config): every numerical knob of FeatureConfig is settable, the config
hash is recorded in the run report, and output is .npy per utterance.
"""

from __future__ import annotations

import argparse
import sys

from .backend import BACKENDS
from .config import FeatureConfig
from .runner import RunnerOptions, run
from .utils import compile_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mfcc_tpu",
        description="MFCC / log-mel / PLP / spectrogram feature extraction")
    p.add_argument("input", help=".wav file, directory, or .txt listing")
    p.add_argument("-o", "--out", default="features", help="output directory")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--no-resume", action="store_true",
                   help="ignore existing manifest")
    p.add_argument("--trace-dir", default=None,
                   help="emit a jax.profiler trace here")
    p.add_argument("--backend", default="auto", choices=BACKENDS,
                   help="execution backend (see mfcc_tpu/backend.py)")
    p.add_argument("--format", default="npy",
                   choices=["npy", "ark", "htk", "tfrecord"],
                   help=".npy per utterance, Kaldi .ark/.scp, or TFRecord")
    p.add_argument("--resample", action="store_true",
                   help="convert foreign-rate WAVs to --sample-rate "
                        "(Kaiser polyphase) instead of quarantining them")
    p.add_argument("--pack", action="store_true",
                   help="splittable multi-utterance row packing: rows "
                        "fill to ~100%% on ragged corpora (the padded "
                        "slack carries real audio) and long utterances "
                        "stream through fixed rows untruncated.  Plain "
                        "MFCC/log-mel/PLP/spectrogram (+ global "
                        "--cmvn); per-piece features are bit-identical "
                        "to the unpacked pipeline")
    p.add_argument("--pack-seconds", type=float, default=10.0,
                   help="packed row capacity in seconds")

    f = p.add_argument_group("feature config")
    f.add_argument("--sample-rate", type=int, default=16000)
    f.add_argument("--frame-ms", type=float, default=25.0)
    f.add_argument("--hop-ms", type=float, default=10.0)
    f.add_argument("--frame-mode", default="valid",
                   choices=["valid", "center"],
                   help="framing convention: 'valid' drops the last "
                        "partial frame (Kaldi snip_edges=true, the "
                        "default); 'center' emits (n + hop/2)//hop "
                        "frames with Kaldi snip_edges=false placement "
                        "and symmetric reflection at the edges "
                        "(librosa-style centering; docs/conventions.md)")
    f.add_argument("--n-fft", type=int, default=512)
    f.add_argument("--window", default="hamming",
                   choices=["hamming", "hann", "povey", "rect"])
    f.add_argument("--preemph", type=float, default=0.97)
    f.add_argument("--n-mels", type=int, default=26)
    f.add_argument("--n-mfcc", type=int, default=13)
    f.add_argument("--fmin", type=float, default=0.0)
    f.add_argument("--fmax", type=float, default=None)
    f.add_argument("--mel-scale", default="htk", choices=["htk", "slaney"])
    f.add_argument("--lifter", type=int, default=0)
    f.add_argument("--vtln-warp", type=float, default=1.0,
                   help="VTLN warp factor (piecewise-linear warp of the "
                        "mel filter edges; 1.0 = off)")
    f.add_argument("--vtln-low", type=float, default=100.0,
                   help="VTLN lower knee frequency (Hz)")
    f.add_argument("--vtln-high", type=float, default=-500.0,
                   help="VTLN upper knee frequency (Hz; negative = "
                        "offset below fmax)")
    f.add_argument("--dither", type=float, default=0.0,
                   help="seeded waveform dither RMS in [-1,1] units "
                        "(Kaldi's 1-LSB default = 1/32768 ~= 3.05e-5)")
    f.add_argument("--dither-seed", type=int, default=0)
    f.add_argument("--dft-algorithm", default="auto",
                   choices=["auto", "direct", "directc", "dit2", "dit2c",
                            "dit4c"],
                   help="batch DFT factorization (auto = measured winner)")
    f.add_argument("--append-energy", action="store_true")
    f.add_argument("--deltas", action="store_true",
                   help="append delta + delta-delta")
    f.add_argument("--cmvn", action="store_true",
                   help="two-pass global mean/variance normalization")
    f.add_argument("--logmel", action="store_true",
                   help="log-mel filterbank output (skip DCT)")
    f.add_argument("--plp", action="store_true",
                   help="PLP cepstra (bark critical bands + LPC model)")
    f.add_argument("--spectrogram", action="store_true",
                   help="log-power spectrogram output (T, n_fft/2+1) — "
                        "no mel, no DCT (models/spectrogram.py; "
                        "contract 2e-4 in a 50 dB window, "
                        "docs/conventions.md)")
    f.add_argument("--n-bark", type=int, default=21,
                   help="PLP critical-band filter count")
    f.add_argument("--lpc-order", type=int, default=12,
                   help="PLP all-pole model order")
    f.add_argument("--pitch", action="store_true",
                   help="append 3-dim Kaldi-style pitch features "
                        "[pov, normalized log pitch, delta] to the output")
    f.add_argument("--cmvn-sliding", type=int, default=0, metavar="WINDOW",
                   help="per-utterance sliding-window CMVN (frames; "
                        "Kaldi apply-cmvn-sliding; 0 = off)")
    f.add_argument("--cmvn-online", type=int, default=0, metavar="WINDOW",
                   help="CAUSAL online CMVN over the trailing WINDOW "
                        "frames (Kaldi apply-cmvn-online; zero lookahead "
                        "— the batch twin of the streaming serving path; "
                        "0 = off)")
    f.add_argument("--cmvn-online-prior", default=None, metavar="CMVN_NPZ",
                   help="cmvn.npz global stats (from a previous --cmvn "
                        "run) blended in while the causal window is "
                        "young (requires --cmvn-online)")
    f.add_argument("--dynamic-range-db", type=float, default=None,
                   metavar="DB",
                   help="per-frame relative energy floor: mel energies "
                        "more than DB below the frame's peak band are "
                        "floored.  Makes the 1e-4 log-mel accuracy "
                        "contract exact by construction (f32 valleys "
                        "below ~60-70 dB are physics-limited; see "
                        "docs/conventions.md accuracy policy)")
    f.add_argument("--splice", type=int, default=0, metavar="N",
                   help="splice +-N context frames (Kaldi splice-feats; "
                        "0 = off)")
    f.add_argument("--vad", action="store_true",
                   help="append a 0/1 energy-VAD column (Kaldi "
                        "compute-vad semantics on the frame log "
                        "energies, threshold 0.0 / mean-scale 0.5 for "
                        "[-1,1] floats — docs/conventions.md).  Computed "
                        "from the audio pre-normalization and appended "
                        "as the LAST column after cmvn/splice; "
                        "incompatible with --cmvn (the two-pass rewrite "
                        "would normalize the indicator)")
    f.add_argument("--vad-context", type=int, default=0, metavar="N",
                   help="energy-VAD +-N-frame majority vote (voiced iff "
                        ">= 60%% of the window passes; 0 = per-frame "
                        "decisions)")
    return p


def config_from_args(a) -> FeatureConfig:
    if sum(map(bool, (a.logmel, a.plp, getattr(a, "spectrogram", False)))) > 1:
        raise SystemExit("--logmel, --plp and --spectrogram are mutually "
                         "exclusive")
    if getattr(a, "spectrogram", False) and a.deltas:
        raise SystemExit("--spectrogram has no delta append (consume the "
                         "raw spectra or use --logmel --deltas)")
    n_mels = a.n_mels
    n_mfcc = n_mels if a.logmel else a.n_mfcc
    return FeatureConfig(
        sample_rate=a.sample_rate, frame_ms=a.frame_ms, hop_ms=a.hop_ms,
        frame_mode=a.frame_mode,
        n_fft=a.n_fft, window=a.window, preemph=a.preemph,
        n_mels=n_mels, n_mfcc=n_mfcc, fmin=a.fmin, fmax=a.fmax,
        mel_scale=a.mel_scale, lifter=a.lifter,
        vtln_warp=a.vtln_warp, vtln_low=a.vtln_low, vtln_high=a.vtln_high,
        dither=a.dither, dither_seed=a.dither_seed,
        dft_algorithm=a.dft_algorithm,
        n_bark=a.n_bark, lpc_order=a.lpc_order,
        dynamic_range_db=a.dynamic_range_db,
        append_energy=a.append_energy, deltas=a.deltas, cmvn=a.cmvn,
    ).validate()


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    if sum(map(bool, (a.cmvn, a.cmvn_sliding, a.cmvn_online))) > 1:
        raise SystemExit("--cmvn (global two-pass), --cmvn-sliding and "
                         "--cmvn-online are mutually exclusive")
    if a.cmvn_online_prior and not a.cmvn_online:
        raise SystemExit("--cmvn-online-prior requires --cmvn-online")
    if a.vad and a.cmvn:
        raise SystemExit("--vad is incompatible with --cmvn (the two-pass "
                         "apply would normalize the 0/1 indicator column); "
                         "use --cmvn-sliding/--cmvn-online or a separate "
                         "VAD pass")
    cfg = config_from_args(a)
    compile_cache.enable()
    opts = RunnerOptions(
        out_dir=a.out, batch_size=a.batch_size, logmel=a.logmel, plp=a.plp,
        spectrogram=a.spectrogram,
        pitch=a.pitch, cmvn_sliding=a.cmvn_sliding,
        cmvn_online=a.cmvn_online, cmvn_online_prior=a.cmvn_online_prior,
        splice=a.splice, vad=a.vad, vad_context=a.vad_context,
        pack=a.pack, pack_seconds=a.pack_seconds,
        resume=not a.no_resume, trace_dir=a.trace_dir, backend=a.backend,
        out_format=a.format, resample=a.resample)
    rep = run(a.input, cfg, opts)
    print(rep.dump())
    if rep.n_utterances == 0:
        print("no utterances processed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
