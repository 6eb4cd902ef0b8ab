"""device_profile._device_runs: which torch.profiler traces count as whole.

The profiler can drop a trace's first events, or its last, while it keeps
their launches.  Each trace holds markers before the first run and after
each; these cases feed _device_runs made-up traces in place of _trace, so
they need no card."""

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a worker)
from whisper_medusa_tpu_torch import device_profile as D

M = ("at::cuda::(anonymous namespace)::spin_kernel(long)", 0.0, 1.0)
A = ("void wm::(anonymous namespace)::a_kernel()", 1.0, 2.0)
B = ("void wm::(anonymous namespace)::b_kernel()", 2.0, 3.0)

CASES = {
    "whole": ([M] * D.LEAD + [A, B, M, A, M], [[A, B], [A]]),
    "leading markers lost": ([M] * 2 + [A, B, M, A, M], [[A, B], [A]]),
    "every leading marker lost": ([A, B, M, A, M], None),
    "the first run's events lost": ([B, M, A, M], None),
    "a trailing marker lost": ([M] * D.LEAD + [A, B, A, M], None),
    "the tail lost": ([M] * D.LEAD + [A, B, M, A], None),
    "nothing": ([], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_runs_takes_whole_traces_only(case, monkeypatch):
    events, want = CASES[case]
    taken = []
    monkeypatch.setattr(D, "_trace", lambda fn, reps, pad_s: taken.append(pad_s) or events)
    if want is None:
        with pytest.raises(RuntimeError, match="no whole trace of 2 runs in 3 tries"):
            D._device_runs(None, 2, tries=3)
        assert taken == [D.PAD_S, 4 * D.PAD_S, 16 * D.PAD_S]
    else:
        assert D._device_runs(None, 2) == want
        assert taken == [D.PAD_S]
        assert D._device_events(None, 2) == [e for run in want for e in run]
