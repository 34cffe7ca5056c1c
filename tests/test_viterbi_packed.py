"""The packed-decision Viterbi path on the CPU: its plain-JAX forward
pass and traceback (the CUDA kernels' contract), the wrapper's
reshaping and start states, the choice of decoder, and how the CUDA
library is built or found."""

import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from r4w_tpu.fec import convolutional as C
from r4w_tpu.kernels import cuda

CODES = {
    "k7r2": (7, (0o171, 0o133)),
    "k5r2": (5, (0o23, 0o35)),
    "k3r2": (3, (0o5, 0o7)),
    "k7r3": (7, (0o133, 0o171, 0o165)),
}


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("code", list(CODES))
def test_packed_matches_scan(code, terminated):
    k, polys = CODES[code]
    rng = np.random.default_rng(k * 10 + len(polys))
    bits = rng.integers(0, 2, (2, 3, 90))
    coded = np.asarray(C.conv_encode(jnp.asarray(bits), k, polys,
                                     terminate=terminated))
    soft = (1.0 - 2.0 * coded) + 0.8 * rng.standard_normal(coded.shape)
    want = np.asarray(C.viterbi_decode_scan(soft, k, polys, terminated,
                                            soft=True))
    got = np.asarray(C.viterbi_decode_packed(soft, k, polys, terminated,
                                             soft=True))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_forward_decision_words_are_the_scan_decisions():
    """Bit s' of the 64-bit word (word 0 low) is set iff target s' took
    predecessor 2m+1, for all 64 states of K=7."""
    k, polys = CODES["k7r2"]
    rng = np.random.default_rng(3)
    rx = rng.standard_normal((5, 40, 2)).astype(np.float32)
    code_of = C._code_table(k, polys)
    dec, final = C.viterbi_forward_ref(jnp.asarray(rx), code_of)
    assert dec.shape == (5, 40, 2) and dec.dtype == jnp.uint32
    assert final.shape == (5, 64)
    # recompute the decisions with a direct numpy ACS
    s = 64
    m = np.full((5, s), -1e9, np.float32)
    m[:, 0] = 0.0
    sign = (1.0 - 2.0 * ((np.arange(4)[:, None] >> np.arange(2)) & 1)
            ).astype(np.float32)
    for t in range(40):
        bm = rx[:, t] @ sign.T                       # (5, C)
        cand = m[:, None, :] + bm[:, code_of.T]      # (5, 2, S)
        c = cand.reshape(5, 2, 32, 2)
        d = (c[..., 1] > c[..., 0]).reshape(5, s)
        m = c.max(-1).reshape(5, s).astype(np.float32)
        words = np.asarray(dec[:, t]).astype(np.uint64)
        packed = words[:, 0] | (words[:, 1] << np.uint64(32))
        want = (d.astype(np.uint64) << np.arange(s, dtype=np.uint64)).sum(-1)
        np.testing.assert_array_equal(packed, want)


def test_traceback_ref_walks_noiseless_decisions():
    k, polys = CODES["k5r2"]
    bits = np.random.default_rng(4).integers(0, 2, (3, 60))
    coded = np.asarray(C.conv_encode(jnp.asarray(bits), k, polys))
    rx = (1.0 - 2.0 * coded).reshape(3, -1, 2).astype(np.float32)
    dec, _ = C.viterbi_forward_ref(jnp.asarray(rx), C._code_table(k, polys))
    out = C.viterbi_traceback_ref(dec, jnp.zeros(3, jnp.int32), 8)
    np.testing.assert_array_equal(np.asarray(out)[:, :60], bits)


def test_packed_rejects_unsupported_constraint():
    with pytest.raises(ValueError):
        C.viterbi_decode_packed(np.zeros(40), 9, (0o561, 0o753))


def test_gpu_backend_dispatches_to_cuda_kernels(monkeypatch):
    """On a CUDA backend viterbi_decode calls the kernels for 3 <= K <= 7
    (stubbed here with their plain-JAX contract) and the scan beyond."""
    calls = []

    def fwd(rx, code_of):
        calls.append("forward")
        return C.viterbi_forward_ref(rx, code_of)

    def tb(dec, start, half):
        calls.append("traceback")
        return C.viterbi_traceback_ref(dec, start, half)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda, "viterbi_forward", fwd)
    monkeypatch.setattr(cuda, "viterbi_traceback", tb)
    bits = np.random.default_rng(5).integers(0, 2, 50)
    coded = np.asarray(C.conv_encode(jnp.asarray(bits)))
    np.testing.assert_array_equal(np.asarray(C.viterbi_decode(coded)), bits)
    assert calls == ["forward", "traceback"]
    calls.clear()
    k9 = (9, (0o561, 0o753))
    coded9 = np.asarray(C.conv_encode(jnp.asarray(bits), *k9))
    np.testing.assert_array_equal(
        np.asarray(C.viterbi_decode(coded9, *k9)), bits)
    assert calls == []


def test_cpu_backend_uses_the_scan(monkeypatch):
    monkeypatch.setattr(cuda, "load", lambda: pytest.fail("kernel loaded"))
    bits = np.random.default_rng(6).integers(0, 2, 30)
    coded = np.asarray(C.conv_encode(jnp.asarray(bits)))
    np.testing.assert_array_equal(np.asarray(C.viterbi_decode(coded)), bits)


def test_build_command_targets_hopper_into_ignored_dir(monkeypatch):
    monkeypatch.setattr(cuda, "nvcc_path", lambda: "/x/nvcc")
    cmd = cuda.build_command(cuda.LIBRARY)
    assert cmd[0] == "/x/nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd and cmd[-1].endswith("viterbi.cu")
    root = cuda.BUILD_DIR.rsplit("/r4w_tpu/", 1)[0]
    rel = cuda.BUILD_DIR[len(root) + 1:] + "/"
    with open(f"{root}/.gitignore") as f:
        assert rel in f.read().split()


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda.nvcc_path()


def test_prebuilt_library_needs_no_nvcc(monkeypatch, tmp_path):
    """A runtime without the CUDA toolkit loads the library that
    R4W_CUDA_LIBRARY names; nvcc is never asked for."""
    lib = tmp_path / "libr4w_cuda.so"
    lib.write_bytes(b"")
    monkeypatch.setenv("R4W_CUDA_LIBRARY", str(lib))
    monkeypatch.setattr(cuda, "nvcc_path",
                        lambda: pytest.fail("nvcc was asked for"))
    assert cuda.library_path() == str(lib)
    monkeypatch.setenv("R4W_CUDA_LIBRARY", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="R4W_CUDA_LIBRARY"):
        cuda.library_path()


def test_build_writes_the_named_library_once(monkeypatch, tmp_path):
    """build(out) compiles into `out` (atomically) and skips a library
    newer than its sources."""
    calls = []

    def fake_nvcc(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda, "nvcc_path", lambda: "/x/nvcc")
    monkeypatch.setattr(cuda.subprocess, "run", fake_nvcc)
    out = str(tmp_path / "lib" / "libr4w_cuda.so")
    assert cuda.build(out) == out and os.path.isfile(out)
    assert cuda.build(out) == out
    assert len(calls) == 1 and calls[0][calls[0].index("-o") + 1] != out


def test_docker_image_ships_the_prebuilt_library():
    """The image's build stage compiles the library to the path its
    runtime stage copies and names in R4W_CUDA_LIBRARY."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "Dockerfile")) as f:
        text = f.read()
    build_stage, runtime_stage = text.split("\nFROM ")[1:]
    built = re.search(r"python -m r4w_tpu\.kernels\.cuda (\S+)",
                      build_stage).group(1)
    assert "-devel-" in build_stage.splitlines()[0]
    assert "-devel-" not in runtime_stage.splitlines()[0]
    assert f"R4W_CUDA_LIBRARY={built}" in runtime_stage
    assert f"COPY --from=build {os.path.dirname(built)} " in runtime_stage
