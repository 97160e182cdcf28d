"""The port stands on torch and numpy alone: it imports, loads and links
nothing of the JAX package, and its own copies of the JAX package's
numpy-only modules (``common.py``, ``utils/codec.py``) behave as those
modules do."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rapidfuzz_tpu_torch")
JAX_PKG = os.path.join(ROOT, "rapidfuzz_tpu")


def test_port_imports_without_jax():
    """Importing every module of the port, and building and loading its
    oracle, brings in no module of jax or the JAX package and maps no
    file under ``rapidfuzz_tpu/``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    code = (
        "import sys\n"
        "import rapidfuzz_tpu_torch\n"
        "import rapidfuzz_tpu_torch.parallel.scan\n"
        "import rapidfuzz_tpu_torch.serve\n"
        "from rapidfuzz_tpu_torch.distance import indel, lcs_seq, osa\n"
        "from rapidfuzz_tpu_torch.distance import levenshtein\n"
        "from rapidfuzz_tpu_torch import fuzz, oracle\n"
        "import rapidfuzz_tpu_torch.ops.cuda.lcs_band_kernel\n"
        "import rapidfuzz_tpu_torch.ops.cuda.osa_kernel\n"
        "from rapidfuzz_tpu_torch.ops.cuda import wlev_kernel\n"
        "from rapidfuzz_tpu_torch.ops.cuda import jaro_kernel\n"
        "from rapidfuzz_tpu_torch.ops.cuda import pair_kernel\n"
        "assert pair_kernel.max_cutoff(pair_kernel.ROWS) == 16383\n"
        "from rapidfuzz_tpu_torch.distance import jaro, jaro_winkler\n"
        "import rapidfuzz_tpu_torch.ops.osa\n"
        "import rapidfuzz_tpu_torch.ops.jaro\n"
        "assert indel.distance('lewenstein', 'levenshtein') == 3\n"
        "assert lcs_seq.distance('lewenstein', 'levenshtein') == 2\n"
        "assert osa.distance('CA', 'AC') == 1\n"
        "assert oracle.osa_dp([1, 2], [2, 1]) == 1\n"
        "assert fuzz.ratio('ab', 'abc') == 0.8\n"
        "assert rapidfuzz_tpu_torch.parallel.CorpusScanner\n"
        "assert rapidfuzz_tpu_torch.common.mask_distance\n"
        "assert levenshtein.distance('kitten', 'sitting') == 3\n"
        "assert wlev_kernel.fits_int32(64, 1024, 1, 2, 3)\n"
        "assert not wlev_kernel.fits_int32(64, 1024, 2 ** 21, 2, 3)\n"
        "import numpy as np, torch\n"
        "from rapidfuzz_tpu_torch.ops.cuda import lev_kernel\n"
        "from rapidfuzz_tpu_torch.utils import codec\n"
        "ch, ln = codec.encode_batch(['sitting', ''])\n"
        "c, l = lev_kernel.prepare_corpus(torch.from_numpy(ch),\n"
        "                                 torch.from_numpy(ln))\n"
        "d = wlev_kernel.wlev_1v_many(codec.encode_one('kitten'), c, l,\n"
        "                             ins=1, dele=2, sub_cost=3)\n"
        "assert d.tolist() == [7, 12], d\n"
        "c, t = jaro_kernel.jaro_1v_many(codec.encode_one('sittign'), c, l)\n"
        "assert c.tolist() == [7, 0] and t.tolist() == [2, 0], (c, t)\n"
        "assert round(jaro.similarity('martha', 'marhta'), 4) == 0.9444\n"
        "assert round(jaro_winkler.similarity('martha', 'marhta'), 4) \\\n"
        "    == 0.9611\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'rapidfuzz_tpu'))\n"
        "assert not bad, bad\n"
        f"jax_pkg = {JAX_PKG + os.sep!r}\n"
        "maps = open('/proc/self/maps').read().split()\n"
        "bad = sorted({p for p in maps if p.startswith(jax_pkg)})\n"
        "assert not bad, bad\n"
        "print('pure')\n")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0 and "pure" in p.stdout, p.stderr[-800:]


def _port_groups():
    """The port's sources, one group per directory, and chip_smoke.py."""
    groups = {}
    for f in sorted(glob.glob(os.path.join(PORT, "**", "*"),
                              recursive=True)):
        if (os.path.splitext(f)[1] in (".py", ".cu", ".cuh")
                and "_build" not in f.split(os.sep)):
            rel = os.path.relpath(f, ROOT)
            groups.setdefault(os.path.dirname(rel), []).append(rel)
    groups["chip_smoke.py"] = ["chip_smoke.py"]
    return groups


PORT_GROUPS = _port_groups()


@pytest.mark.parametrize("group", sorted(PORT_GROUPS))
def test_port_files_are_its_own(group):
    """No file of the port, and not ``chip_smoke.py``, is a symlink or
    resolves under ``rapidfuzz_tpu/``, and none imports jax or the JAX
    package."""
    import ast

    for rel in PORT_GROUPS[group]:
        path = os.path.join(ROOT, rel)
        assert not os.path.islink(path), rel
        real = os.path.realpath(path)
        assert not real.startswith(JAX_PKG + os.sep), real
        if not rel.endswith(".py"):
            continue
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "rapidfuzz_tpu"), (rel, name)


#: inputs of every encoding route (str, bytes, int sequences past int32
#: through the vocab remap, numpy arrays).  Negative and past-int64
#: elements are left out: both codecs intern them in a table of their
#: own, whose codes depend on what the process encoded before.
CODEC_INPUTS = [
    ["kitten", "sitting", "", "Иванко", "😀a"],
    [b"bytes", b"", b"\x00\xff"],
    [[1, 2, 3], [2 ** 40, 5, 7], [], [2 ** 63 - 1, 0]],
    [np.array([3, 1, 2], np.uint64), np.array([9, 5], np.int64)],
]


def _codec_outputs(codec):
    out = []
    for batch in CODEC_INPUTS:
        out.append([codec.encode_one(s) for s in batch])
        out.append(codec.encode_batch(batch))
        out.append(codec.encode_batch(batch, 64))
        out.append(codec.encode_pair_batch(batch, batch[::-1]))
    out.append([codec.bucket_len(n) for n in (0, 1, 32, 33, 1025, 131073)])
    return out


def _common_outputs(common):
    raw = np.array([0, 1, 2, 3, 5, 8])
    out = [common.mask_distance(raw, c) for c in (None, 0, 2, 2.5, -1)]
    out += [common.mask_similarity(raw, c) for c in (None, 0, 3, 7)]
    out += [common.apply_distance_cutoff(3, c) for c in (None, 2, 3)]
    out += [common.apply_similarity_cutoff(3, c) for c in (None, 3, 4)]
    out += [common.norm_dist_from_dist(d, m) for d, m in ((0, 0), (3, 7))]
    args = common.ArgsBase().score_cutoff(2).score_hint(5)
    out += [(args.cutoff, args.hint), common.scalar_backend()]
    return out


def _assert_same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("rel", ["common.py", os.path.join("utils",
                                                          "codec.py")])
def test_numpy_modules_match_the_jax_package(rel):
    """The port's copy gives the JAX package's module's outputs, dtypes
    included, on the same inputs (the two files may differ in text)."""
    if rel == "common.py":
        from rapidfuzz_tpu import common as ref
        from rapidfuzz_tpu_torch import common as port
        _assert_same(_common_outputs(port), _common_outputs(ref))
    else:
        from rapidfuzz_tpu.utils import codec as ref
        from rapidfuzz_tpu_torch.utils import codec as port
        _assert_same(_codec_outputs(port), _codec_outputs(ref))
