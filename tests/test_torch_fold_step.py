"""The port's ``make_fold_step`` against the reference's, bit for bit.

The reference closes a plan's fold geometry over once
(``repro.kernels.fused_fold.ops.make_fold_step``, its Pallas kernel in
interpret mode here); so does the port, whose step runs the plain
PyTorch version on CPU tensors.  The same numpy rows go through both for
two consecutive micro-batches, across both wires, every fold kind, dense
and hashed key spaces, a carry wider than the key space and the upper
channel pair of a 4-channel carry.  Values are integers, so every
comparison is exact (tolerance zero).  A bad geometry raises when the
step is made, with the one-off ``fold``'s errors; the stream aggregate
makes its step once.  The kernel's own tests run on the card
(``test_torch_fold_step_cuda.py``).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.fused_fold.ops import make_fold_step as jax_make_step

from repro_torch.engine import plan as plan_mod
from repro_torch.engine.plan import (ExecutionPlan, KeySpace, ReduceSpec,
                                     WindowSpec)
from repro_torch.kernels.fused_fold import ops
from repro_torch.kernels.fused_fold.ref import FOLD_KINDS

N_SLOTS, NB, FANOUT = 6, 16, 4
WIDE = NB + 5


def _rows(rng, n, *, host_wire, keymax, n_slots=N_SLOTS):
    """Integer-valued wire rows; device-wire window indices reach below
    zero and below ``min_window`` (late); about 15% invalid."""
    if host_wire:
        cols = [rng.integers(0, n_slots, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.15]
    else:
        cols = [rng.integers(-9, 3 * n_slots, n),
                rng.integers(0, FANOUT + 1, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.15]
    return np.stack(cols, axis=1).astype(np.float32)


def _carry(rng, size, channels, kind):
    carry = rng.integers(0, 5, (size, channels)).astype(np.float32)
    if kind in ("min", "max"):      # the carry contract: count 0 -> value 0
        for b in range(0, channels, 2):
            carry[:, b] = np.where(carry[:, b + 1] > 0, carry[:, b], 0.0)
    return carry


# (host_wire, kind, hashed, carry_buckets, channel_base, channels)
CASES = [(hw, kind, hashed, NB, 0, 2) for hw in (False, True)
         for kind in FOLD_KINDS for hashed in (False, True)]
CASES += [(False, kind, False, WIDE, base, 4) for kind in ("sum", "count")
          for base in (0, 2)]
CASES += [(False, "max", True, NB, 2, 4), (True, "min", False, WIDE, 2, 4)]


def _id(case):
    hw, kind, hashed, cb, base, channels = case
    return (f"{'host' if hw else 'device'}-{kind}-"
            f"{'hashed' if hashed else 'dense'}-cb{cb}-base{base}of{channels}")


@pytest.mark.parametrize("host_wire,kind,hashed,carry_buckets,base,channels",
                         CASES, ids=[_id(c) for c in CASES])
def test_fold_step_matches_reference_step_and_fold(host_wire, kind, hashed,
                                                   carry_buckets, base,
                                                   channels):
    """Two consecutive micro-batches through the reference's step (Pallas
    kernel, interpret mode), the port's step and the one-off ``fold``:
    carries and stats equal after each, exactly; the port's step writes
    the carry in place."""
    rng = np.random.default_rng(43)
    keymax = (1 << 24) if hashed else NB
    geometry = dict(fanout=1 if host_wire else FANOUT, n_slots=N_SLOTS,
                    num_buckets=NB, carry_buckets=carry_buckets,
                    channel_base=base, hashed=hashed, host_wire=host_wire,
                    kind=kind)
    jstep = jax_make_step(**geometry, use_pallas=True, interpret=True,
                          block_n=128)
    step = ops.make_fold_step(**geometry, device="cpu")
    carry0 = _carry(rng, N_SLOTS * carry_buckets, channels, kind)
    jc = jnp.asarray(carry0)
    pc = torch.from_numpy(carry0.copy())
    fc = torch.from_numpy(carry0.copy())
    late = 0
    for minw in (2, 5):
        rows = _rows(rng, 300, host_wire=host_wire, keymax=keymax)
        t_rows = torch.from_numpy(rows)
        if host_wire:
            jc, js = jstep(jnp.asarray(rows), jc)
            out, ps = step(t_rows, pc)
        else:
            jc, js = jstep(jnp.asarray(rows), jc, minw)
            out, ps = step(t_rows, pc, minw)
        assert out is pc
        fc, fs = ops.fold(t_rows, fc, None if host_wire else minw,
                          **geometry)
        assert np.array_equal(pc.numpy(), np.asarray(jc))
        assert np.array_equal(ps.numpy(), np.asarray(js))
        assert torch.equal(fc, pc) and torch.equal(fs, ps)
        late += int(ps[0])
    assert (late > 0) != host_wire               # late pairs were exercised
    if channels == 4:
        others = [c for c in range(4) if c not in (base, base + 1)]
        assert torch.equal(pc[:, others],
                           torch.from_numpy(carry0[:, others]))
    if carry_buckets > NB:                       # rows past the key space
        view = pc.reshape(N_SLOTS, carry_buckets, channels)
        assert torch.equal(view[:, NB:], torch.from_numpy(
            carry0).reshape(N_SLOTS, carry_buckets, channels)[:, NB:])


_GOOD = dict(fanout=2, n_slots=4, num_buckets=8, carry_buckets=8)


@pytest.mark.parametrize("bad,error,match", [
    (dict(kind="median"), ValueError, "unknown fold kind"),
    (dict(channel_base=-2), ValueError, r"channel window \[base, base\+2\)"),
    (dict(n_slots=0), ValueError, "positive sizes"),
    (dict(carry_buckets=0), ValueError, "positive sizes"),
], ids=["kind", "base", "slots", "buckets"])
def test_bad_geometry_raises_when_the_step_is_made(bad, error, match):
    """A geometry no carry can take is refused by ``make_fold_step``
    itself, with the one-off ``fold``'s error type and message."""
    with pytest.raises(error, match=match):
        ops.make_fold_step(**{**_GOOD, **bad}, device="cpu")
    if "kind" in bad:
        with pytest.raises(error, match=match):
            ops.fold(torch.zeros((4, 5)), torch.zeros((32, 2)), 0,
                     **{**_GOOD, **bad})


def test_step_checks_what_can_change_per_call():
    """Per call, the step refuses rows of the other wire's width, a carry
    of another shape or too few channels for its base, other dtypes and
    rows and carry on different devices — as ``fold`` does."""
    step = ops.make_fold_step(**_GOOD, channel_base=2, device="cpu")
    rows, carry = torch.zeros((4, 5)), torch.zeros((32, 4))
    step(rows, carry, 0)
    with pytest.raises(ValueError, match="width-5"):
        step(torch.zeros((4, 4)), carry, 0)
    with pytest.raises(ValueError, match="carry has shape"):
        step(rows, torch.zeros((30, 4)), 0)
    with pytest.raises(ValueError, match="channel window"):
        step(rows, torch.zeros((32, 3)), 0)
    with pytest.raises(TypeError, match="float32"):
        step(rows.double(), carry, 0)
    with pytest.raises(ValueError, match="rows on meta"):
        step(torch.zeros((4, 5), device="meta"), carry, 0)
    host = ops.make_fold_step(**_GOOD, host_wire=True, device="cpu")
    host(torch.zeros((4, 4)), torch.zeros((32, 2)))


@pytest.mark.parametrize("host_wire", [False, True], ids=["device", "host"])
def test_consecutive_steps_return_distinct_stats(host_wire):
    """Each step returns a stats tensor of its own: a caller that keeps
    every fold's stats until a later barrier (the coordinator's deferred
    drain) reads each fold's counters, not the last one's."""
    rng = np.random.default_rng(47)
    step = ops.make_fold_step(fanout=1 if host_wire else FANOUT,
                              n_slots=N_SLOTS, num_buckets=NB,
                              carry_buckets=NB, host_wire=host_wire,
                              device="cpu")
    carry = torch.zeros((N_SLOTS * NB, 2))
    extra = () if host_wire else (2,)
    kept = []
    for n in (100, 250):
        rows = torch.from_numpy(_rows(rng, n, host_wire=host_wire,
                                      keymax=NB))
        _, stats = step(rows, carry, *extra)
        kept.append((stats, stats.clone()))
    (first, first_copy), (second, _) = kept
    assert first is not second and first.data_ptr() != second.data_ptr()
    assert torch.equal(first, first_copy)
    assert not torch.equal(first, second)


def test_stream_aggregate_makes_its_step_once(monkeypatch):
    """``CompiledStreamAggregate`` makes its fold step where it is built,
    once, and every ``step`` goes through it."""
    made, real = [], ops.make_fold_step

    def counting(**kw):
        made.append(kw)
        return real(**kw)

    monkeypatch.setattr(plan_mod.fused_fold, "make_fold_step", counting)
    plan = ExecutionPlan(KeySpace.dense(NB), ReduceSpec(), 4,
                         WindowSpec(100.0, 25.0, N_SLOTS))
    compiled = plan.compile(device="cpu")
    assert len(made) == 1
    assert made[0] == dict(fanout=plan.window.fanout, n_slots=N_SLOTS,
                           num_buckets=NB, carry_buckets=plan.carry_buckets,
                           channel_base=0, hashed=False, host_wire=False,
                           kind="sum", device=torch.device("cpu"))
    rng = np.random.default_rng(53)
    carry = compiled.init_carry()
    for _ in range(3):
        carry, stats = compiled.step(
            _rows(rng, 200, host_wire=False, keymax=NB,
                  n_slots=N_SLOTS), carry, 0)
    assert len(made) == 1 and int(stats[1]) > 0


def _c_layout(source: str, tmp_path) -> tuple:
    """Field offsets and size of the source's ``FoldGeometry`` as the
    host's C++ compiler lays it out."""
    body = re.search(r"struct FoldGeometry \{(.*?)\};", source, re.S).group(1)
    names = re.findall(r"\b(\w+);", body)
    prog = tmp_path / "layout.cpp"
    prog.write_text(
        "#include <cstddef>\n#include <cstdio>\n"
        f"struct FoldGeometry {{{body}}};\nint main() {{\n"
        + "".join(f'  std::printf("%zu\\n", offsetof(FoldGeometry, {n}));\n'
                  for n in names)
        + '  std::printf("%zu\\n", sizeof(FoldGeometry));\n}\n')
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "a host C++ compiler checks the struct layout"
    exe = tmp_path / "layout"
    subprocess.run([compiler, "-o", str(exe), str(prog)], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout.split()
    return names, [int(x) for x in out]


def test_packed_geometry_matches_the_kernel_struct(tmp_path):
    """The ctypes ``_Geometry`` the step packs once has the kernel's
    ``FoldGeometry`` fields in its order, at its offsets and size — a
    mismatch would pass garbage to every launch, silently."""
    source = pathlib.Path(ops.__file__).parent / "csrc" / "fused_fold.cu"
    names, layout = _c_layout(source.read_text(), tmp_path)
    fields = [name for name, _ in ops._Geometry._fields_]
    assert names == fields
    assert layout[:-1] == [getattr(ops._Geometry, n).offset for n in fields]
    assert layout[-1] == ctypes.sizeof(ops._Geometry)
    step = ops.make_fold_step(**_GOOD, channel_base=2, hashed=True,
                              kind="max", device="cpu")
    g = step.geometry
    assert (g.size, g.fanout, g.n_slots, g.num_buckets, g.carry_buckets,
            g.channel_base, g.hashed, g.host_wire, g.kind) == \
        (32, 2, 4, 8, 8, 2, 1, 0, FOLD_KINDS.index("max"))
