"""``runtime.graphs``: the chains of stages that the batched receivers
replay from CUDA graphs on the card.

A CUDA graph needs the card. Here a chain whose capture records an eager
rerun in the graph's place holds what the chain itself decides: which
arguments it copies into its buffers and which it reads where they lie,
that its results are the same buffers call after call, that its stages
keep their order, and that the launch registry counts a replay's
launches once. On the CPU the batched receiver takes ``EAGER``.
"""

from __future__ import annotations

import pytest
import torch

from empower_srslte_tpu_torch.models import ue_dl
from empower_srslte_tpu_torch.runtime import graphs, trace


class RerunStages(graphs.Stages):
    """A chain whose "graph" reruns the stage into its first results."""

    def _record(self, device, fn, args, kwargs):
        fn(*args, **kwargs)                      # the side stream's run
        with trace.launches_aside() as launches:
            result = fn(*args, **kwargs)         # the capture
        first = graphs._flat(result)

        def replay():
            with trace.launches_aside():
                again = graphs._flat(fn(*args, **kwargs))
            for r, a in zip(first, again):
                r.copy_(a)
        return replay, result, launches


def scaled(x, scale: float):
    trace.count_launch("ka", tuple(x.shape))
    return x * scale, x.sum(-1)


def shifted(y, shift):
    trace.count_launch("kb", tuple(y.shape))
    return y + shift


def call(chain, x):
    chain.start()
    y, s = chain("t.scaled", scaled, x, 2.0)
    return chain("t.shifted", shifted, y[:, 1:], s[:, None]), s


@pytest.fixture
def fresh_registry():
    trace.reset()
    yield
    trace.reset()


def test_a_chain_copies_its_inputs_and_reads_its_own_results(fresh_registry):
    chain = RerunStages()
    x1, x2 = torch.arange(12.0).view(3, 4), -torch.arange(12.0).view(3, 4)
    out1, s1 = call(chain, x1)
    assert torch.equal(out1, x1[:, 1:] * 2 + x1.sum(-1)[:, None])
    static = chain._graphs[0][2][0]
    assert static.data_ptr() != x1.data_ptr()    # the input: a copy
    y_static = chain._graphs[1][2][0]
    assert (y_static.untyped_storage().data_ptr()
            == chain._graphs[0][3][0].untyped_storage().data_ptr())
    out2, s2 = call(chain, x2)
    assert out2 is out1 and s2 is s1              # the graph's buffers
    assert torch.equal(out2, x2[:, 1:] * 2 + x2.sum(-1)[:, None])
    assert torch.equal(static, x2)
    assert torch.equal(x1, torch.arange(12.0).view(3, 4))   # left as it was


def test_a_replay_counts_its_launches_once(fresh_registry):
    chain = RerunStages()
    x = torch.ones(2, 3)
    call(chain, x)                   # the side stream's run and a replay
    assert trace.launch_counts() == {"ka": 2, "kb": 2}
    trace.reset()
    call(chain, x)
    call(chain, x)
    assert trace.launch_counts() == {"ka": 2, "kb": 2}
    assert trace.launch_shapes("kb") == {(2, 2): 2}


def test_launches_aside_nest_and_leave_the_registry(fresh_registry):
    with trace.launches_aside() as outer:
        trace.count_launch("k", 1)
        with trace.launches_aside() as inner:
            trace.count_launch("k", 2)
        trace.count_launch("k", 1)
    assert outer == {("k", 1): 2} and inner == {("k", 2): 1}
    assert trace.launch_counts() == {}
    trace.count_launches(outer)
    assert trace.launch_shapes("k") == {1: 2}


def test_a_chain_refuses_an_argument_of_another_shape():
    chain = RerunStages()
    call(chain, torch.ones(2, 3))
    with pytest.raises(ValueError, match="t.scaled"):
        call(chain, torch.ones(2, 4))


def test_a_chain_keeps_its_stages_order():
    chain = RerunStages()
    x = torch.ones(2, 3)
    call(chain, x)
    chain.start()
    with pytest.raises(RuntimeError, match="t.shifted"):
        chain("t.shifted", shifted, x, x)


def test_the_batched_receiver_runs_eagerly_off_the_card():
    cfg = object()
    assert ue_dl._chain(torch.zeros(1, 2, 8), cfg, None) is graphs.EAGER
    assert graphs.EAGER("t.scaled", scaled, torch.ones(1, 2), 3.0)[1] == 2


def test_what_a_caller_keeps_is_a_copy_of_the_graph_buffer():
    x = torch.ones(3)
    assert graphs.EAGER.keep(x) is x
    kept = graphs.Stages.keep(x)
    assert kept is not x and torch.equal(kept, x)


def test_a_chain_given_its_device_takes_a_stage_without_tensors(
        fresh_registry):
    """A chain made for its device captures a stage with no tensor
    argument (a transmitter call with no DCI and no HI)."""
    chain = RerunStages(torch.device("cpu"))
    for n in (3, 3):
        chain.start()
        out = chain("t.made", lambda v: torch.full((2,), float(v)), n)
        assert torch.equal(out, torch.full((2,), 3.0))
    assert len(chain._graphs) == 1 and chain._graphs[0][2] == []
