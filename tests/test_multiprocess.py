"""True multi-process distributed test (config 5, process level).

Spawns TWO separate Python processes that wire up via
``jax.distributed.initialize`` (TCP coordinator — the same mechanism as
a real multi-host pod, with CPU devices standing in for chips), each
extracting features for its host shard and participating in the global
CMVN reduction.  This covers what the fake-pod (single-process 8-device)
tests cannot: process-boundary collectives and host-shard data flow.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mfcc_tpu.utils import wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_global_cmvn(tmp_path, rng, nproc):
    """n=4 exercises the strided host_shard + cross-process reduction
    beyond the degenerate two-participant case (VERDICT r4 #3)."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(4 * nproc):
        x = (rng.standard_normal(12000) * 0.3).astype(np.float32)
        wav.write_wav(corpus / f"u{i}.wav", x, 16000)

    worker = os.path.join(os.path.dirname(__file__), "mp_cmvn_worker.py")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), str(corpus),
         str(tmp_path), str(nproc)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nproc)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    assert (tmp_path / "mp_ok").exists(), outs[0][-2000:]


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_runner_end_to_end(tmp_path, rng, nproc):
    """The PRODUCTION runner on 2 and 4 processes: host-sharded corpus,
    local compute, per-host writers/manifests, global float64 CMVN —
    outputs must match a single-process run of the same corpus
    (VERDICT r1 #4; the 4-process case covers strided-shard and
    reduction-order paths that n=2 leaves degenerate, VERDICT r4 #3)."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(2 * nproc + 1):   # odd count: uneven host shards
        x = (rng.standard_normal(int(rng.integers(8000, 14000)))
             * 0.3).astype(np.float32)
        wav.write_wav(corpus / f"u{i}.wav", x, 16000)

    # single-process reference (fresh interpreter: no jax.distributed)
    ref_dir = tmp_path / "ref"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv=['x']; "
         "from mfcc_tpu import FeatureConfig, runner; "
         f"runner.run({str(str(corpus))!r}, "
         "FeatureConfig(cmvn=True).validate(), "
         f"runner.RunnerOptions(out_dir={str(str(ref_dir))!r}, "
         "batch_size=2))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

    out_dir = tmp_path / "out"
    worker = os.path.join(os.path.dirname(__file__), "mp_runner_worker.py")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), str(corpus),
         str(out_dir), str(nproc)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(nproc)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    # every utterance present exactly once, equal to the single-process
    # run (global stats are identical f64 sums up to summation order)
    for i in range(2 * nproc + 1):
        want = np.load(ref_dir / f"u{i}.npy")
        got = np.load(out_dir / f"u{i}.npy")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # per-host manifests + reports exist
    for r in range(nproc):
        assert (out_dir / f"manifest.{r}.json").exists()
        assert (out_dir / f"run_report.{r}.json").exists()


@pytest.mark.slow
def test_two_process_runner_packed(tmp_path, rng):
    """--pack on the multi-process runner: each host packs its own
    corpus shard; global CMVN still reduces across processes; outputs
    match a single-process unpacked run (r5)."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for i in range(7):
        x = (rng.standard_normal(int(rng.integers(8000, 20000)))
             * 0.3).astype(np.float32)
        wav.write_wav(corpus / f"u{i}.wav", x, 16000)

    ref_dir = tmp_path / "ref"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.argv=['x']; "
         "from mfcc_tpu import FeatureConfig, runner; "
         f"runner.run({str(str(corpus))!r}, "
         "FeatureConfig(cmvn=True).validate(), "
         f"runner.RunnerOptions(out_dir={str(str(ref_dir))!r}, "
         "batch_size=2))"],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]

    out_dir = tmp_path / "out"
    worker = os.path.join(os.path.dirname(__file__), "mp_runner_worker.py")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(port), str(corpus),
         str(out_dir), "2", "pack"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    for i in range(7):
        want = np.load(ref_dir / f"u{i}.npy")
        got = np.load(out_dir / f"u{i}.npy")
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
