"""Every C entry's argument count matches its ctypes signature.

``ops/cuda_lib.py::_SIGNATURES`` gives ctypes the argument types of each
``extern "C" int wm_*(...)`` in ``csrc/*.cu``.  A count that differs passes
every CPU test (the plain versions never call C) and then hands the kernel
wrong arguments on the card, so each entry is parsed from its source and
its parameters counted, one case per entry.  The entries whose arguments
changed with a kernel's redesign are also held to their counts by name.
"""

import os
import re

import pytest

from whisper_medusa_tpu_torch.ops import cuda_lib

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(wm_\w+)\s*\(([^)]*)\)', re.S)


def _entries():
    found = {}
    for name in sorted(os.listdir(cuda_lib.CSRC_DIR)):
        if name.endswith(".cu"):
            with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
                for entry, params in _ENTRY.findall(f.read()):
                    assert entry not in found, f"{entry} defined twice"
                    params = params.strip()
                    found[entry] = 0 if params in ("", "void") else params.count(",") + 1
    return found


def test_every_c_entry_has_a_signature():
    assert set(_entries()) == set(cuda_lib._SIGNATURES)


@pytest.mark.parametrize("entry", sorted(cuda_lib._SIGNATURES))
def test_argument_count_matches_signature(entry):
    entries = _entries()
    assert entry in entries, f"no extern \"C\" int {entry}(...) in csrc/*.cu"
    assert entries[entry] == len(cuda_lib._SIGNATURES[entry]), (
        f"{entry}: {entries[entry]} C parameters, {len(cuda_lib._SIGNATURES[entry])} "
        "in ops/cuda_lib.py::_SIGNATURES")


# Entries whose argument lists changed: K10's mask mode takes the chunk's
# width beside a block's rows; K9's dQ scratch is now one partial per
# 128-key block (same count, larger buffer), and its f32 mode takes the
# same scratch; K2 keeps its table and ints; K7 keeps (x, e, s, y, m, v, d,
# stream).
@pytest.mark.parametrize("entry,count", [("wm_self_decode", 12), ("wm_attention_bwd", 19),
                                         ("wm_attention_bwd_f32", 19),
                                         ("wm_megastep_step", 3), ("wm_qmm_nt", 8)])
def test_changed_entries_keep_their_counts(entry, count):
    assert _entries()[entry] == count
    assert len(cuda_lib._SIGNATURES[entry]) == count
