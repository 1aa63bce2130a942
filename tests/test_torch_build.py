"""The one seam every hand-written kernel of the port is wired through
(advoc_tpu_torch.ops.kernels._build), on a stand-in declaration, on the CPU.

A :func:`_build.kernel` sends a CPU call to its plain version, a traced
call to its registered operator, and a traced call inside
``plain_when_traced`` to its plain version's aten ops when it stands for no
Pallas kernel (to its operator when it does); on the card (a stand-in tensor
that reports a CUDA device) it refuses what autograd would record and
launches the rest. A :class:`_build.Library` loads nothing until its first
launch.
"""

import collections

import pytest
import torch

from advoc_tpu_torch.ops.kernels import _build


@torch.library.custom_op("advoc_seam_test::twice", mutates_args=(), device_types="cpu")
def _twice_op(x: torch.Tensor) -> torch.Tensor:
    return x * 2


@_twice_op.register_fake
def _(x):
    return torch.empty_like(x)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for the rule's card branch."""

    @property
    def is_cuda(self):
        return True


def _stand_in(pallas: bool, calls: list):
    def plain(x):
        calls.append("plain")
        return x + x

    def launch(x):
        calls.append("launch")
        return x.detach() * 2

    def op(x):
        calls.append("op")
        return _twice_op(x)

    return _build.kernel("twice_kernel", plain=plain, launch=launch, op=op, pallas=pallas,
                         instead="x + x")


def _custom_ops(program) -> list[str]:
    return [n.target.name() for n in program.graph_module.graph.nodes
            if n.op == "call_function" and callable(getattr(n.target, "name", None))
            and n.target.name().startswith("advoc_seam_test::")]


@pytest.mark.parametrize("pallas", [False, True])
def test_rule_on_a_stand_in_declaration(pallas):
    """CPU → plain; traced → the operator; traced inside plain_when_traced →
    plain aten for a kernel that stands for no Pallas kernel, the operator
    for one that does; plain_when_traced ends with its block."""
    calls = []
    kernel = _stand_in(pallas, calls)
    x = torch.arange(6.0).reshape(2, 3)

    assert torch.equal(kernel(x), x + x) and calls == ["plain"]

    class Call(torch.nn.Module):
        def forward(self, x):
            return kernel(x)

    calls.clear()
    program = torch.export.export(Call(), (x,))
    assert calls == ["op"] and _custom_ops(program) == ["advoc_seam_test::twice"]
    calls.clear()
    with _build.plain_when_traced():
        program = torch.export.export(Call(), (x,))
    assert calls == (["op"] if pallas else ["plain"])
    assert _custom_ops(program) == (["advoc_seam_test::twice"] if pallas else [])
    assert torch.equal(program.module()(x), x + x)
    calls.clear()
    program = torch.export.export(Call(), (x,))
    assert calls == ["op"] and _custom_ops(program) == ["advoc_seam_test::twice"]


def test_rule_on_the_card_refuses_autograd_then_launches():
    """On the card a call autograd would record raises, naming the
    differentiable path; without grad, or on tensors needing none, it
    launches."""
    calls = []
    kernel = _stand_in(False, calls)
    x = torch.ones(4).as_subclass(_OnCard).requires_grad_(True)
    with pytest.raises(NotImplementedError, match=r"twice_kernel .* no backward.*x \+ x"):
        kernel(x)
    assert calls == []
    with torch.no_grad():
        kernel(x)
    kernel(x.detach())
    assert calls == ["launch", "launch"]


def test_records_is_autograd_recording():
    """True only with grad enabled and a tensor (or one in a tuple) that
    requires it; other arguments are skipped."""
    w = torch.ones(2, requires_grad=True)
    x = torch.ones(2)
    assert _build.records((w,)) and _build.records((x, 3, "relu", (x, w)))
    assert not _build.records((x, 3, None, (x, x)))
    with torch.no_grad():
        assert not _build.records((w, (w,)))


def test_a_library_loads_at_its_first_launch():
    """Declaring a library builds and loads nothing (a process pays only for
    the libraries it launches); the counter is one Counter by key."""
    lib = _build.Library("no_such_source", "no_such_counter", 2, entry=[_build.PTR, _build.INT])
    assert lib.entries == {"entry": [_build.PTR, _build.INT]} and lib.per_call == 2
    assert lib._fns is None
    with pytest.raises(FileNotFoundError):  # the first launch builds, from a source
        lib.launch(torch.device("cuda", 0), "entry", 0, 0)
    assert isinstance(_build.launches, collections.Counter)
    assert _build.launches["no_such_counter"] == 0
