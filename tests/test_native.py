"""Native C++ tooling tests: CLI + ctypes library parity with the oracles."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from raytracer.io import artifacts
from raytracer.native import bvhtool
from raytracer.ops.lbvh import build_lbvh2
from raytracer.reference.collapse_oracle import collapse_oracle, promote_wide_oracle
from raytracer.utils import procgen

REPO = Path(__file__).resolve().parents[1]
CLI = REPO / "bin" / "bvh_convert"

needs_native = pytest.mark.skipif(
    not bvhtool.available() or not CLI.exists(),
    reason="native tooling not built (run raytracer/native/build.sh)",
)


def _bvh2_image():
    tris = procgen.make_icosphere(3)
    bvh = build_lbvh2(tris)
    return artifacts.bvh2_to_u32(
        np.asarray(bvh.bounds_u32),
        np.asarray(bvh.left),
        np.asarray(bvh.right),
        np.asarray(bvh.meta),
    )


@needs_native
def test_native_promote_matches_oracle():
    buf2 = _bvh2_image()
    out, leaves, internals = bvhtool.promote_wide_native(buf2)
    b2, l2, r2, m2 = artifacts.bvh2_from_u32(buf2)
    want_b, want_c, want_m = promote_wide_oracle(b2, l2, r2, m2)
    want = artifacts.bvh4_to_u32(want_b, want_c, want_m)
    np.testing.assert_array_equal(out, want)
    n = len(m2)
    assert leaves == (n + 1) // 2 and internals == n // 2


@needs_native
def test_native_collapse_matches_oracle():
    buf2 = _bvh2_image()
    out = bvhtool.collapse4_native(buf2)
    b2, l2, r2, m2 = artifacts.bvh2_from_u32(buf2)
    want_b, want_c, want_m = collapse_oracle(b2, l2, r2, m2)
    want = artifacts.bvh4_to_u32(want_b, want_c, want_m)
    np.testing.assert_array_equal(out, want)


@needs_native
def test_cli_end_to_end(tmp_path):
    buf2 = _bvh2_image()
    in_path = tmp_path / "BVH2.bin"
    out_path = tmp_path / "BVH4_wide.bin"
    artifacts.save_u32_bin(in_path, buf2)

    res = subprocess.run(
        [str(CLI), str(in_path), str(out_path)], capture_output=True, text=True
    )
    assert res.returncode == 0, res.stderr
    assert "time:" in res.stdout and "leaves:" in res.stdout
    assert "Node 0 | depth 0" in res.stdout

    out = artifacts.load_u32_bin(out_path)
    b2, l2, r2, m2 = artifacts.bvh2_from_u32(buf2)
    want_b, want_c, want_m = promote_wide_oracle(b2, l2, r2, m2)
    np.testing.assert_array_equal(out, artifacts.bvh4_to_u32(want_b, want_c, want_m))


@needs_native
def test_cli_collapse_mode(tmp_path):
    buf2 = _bvh2_image()
    in_path = tmp_path / "BVH2.bin"
    out_path = tmp_path / "out.bin"
    artifacts.save_u32_bin(in_path, buf2)
    res = subprocess.run(
        [str(CLI), "--collapse", str(in_path), str(out_path)],
        capture_output=True,
        text=True,
    )
    assert res.returncode == 0, res.stderr
    out = artifacts.load_u32_bin(out_path)
    np.testing.assert_array_equal(out, bvhtool.collapse4_native(buf2))


@needs_native
def test_cli_missing_input(tmp_path):
    res = subprocess.run(
        [str(CLI), str(tmp_path / "nope.bin")], capture_output=True, text=True
    )
    assert res.returncode != 0
    assert "error" in res.stderr.lower()
