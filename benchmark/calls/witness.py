"""One batch of witnesses per request: the program's batched replay
(``witness.WitnessProgram.generate``, host big ops then the device program)
over ``batch`` distinct instances; successive requests alternate between the
``batches`` batches made at set-up.

The inputs are the benchmark's: each instance's input cells from the frozen
synthesis of its request, whose full witness is the reference answer. That
synthesis is the reference's work, timed apart and left out of ``setup_s``.
Judged: every cell of every batch the window returned. Compared:
``witnesses_wrong`` (instances with any cell unlike the reference's), limit 0.

Traffic parameters: ``keys``, ``batch``, ``batches``, ``trace_requests``.
Faults (controls only): ``alter`` flips a bit of one cell of request 0;
``half`` answers the batch's second half with its first; ``stale`` answers
each request after the first with the batch before.
"""

from __future__ import annotations

import numpy as np

from harness import circuits, traffic


def prepare(run) -> None:
    from halo2_rsa_tpu_torch.witness.replay import WitnessProgram

    size, count = run.traffic["batch"], run.traffic["batches"]
    reqs = traffic.requests(run, 0, size * count)
    template = circuits.program_circuit(run.cfg, reqs[0]).builder
    circuits.check_size(run.cfg, template)
    prog = WitnessProgram(template)
    cells = template.input_cells()
    batches, expected = [], []
    with run.apart():  # the reference's answers, and the inputs read off them
        for b in range(count):
            insts, want = [], []
            for req in reqs[b * size:(b + 1) * size]:
                ref, _ = circuits.reference_circuit(run.cfg, req)
                if ref.input_cells() != cells:
                    raise AssertionError("the frozen synthesis has other input cells than the "
                                         "program")
                insts.append({c: ref.values[c] for c in cells})
                want.append(circuits.limbs(ref.values))
            batches.append(insts)
            expected.append(np.stack(want))
    run.state.update(prog=prog, batches=batches, expected=expected)
    prog.generate(batches[0], device=run.device)  # the cell's own shapes, once
    if run.trace:
        for name, span in (("host_inputs", "replay_host"), ("run", "replay_device")):
            real = getattr(prog, name)

            def wrapped(*args, _real=real, _span=span, **kw):
                with run.span(_span):
                    return _real(*args, **kw)

            setattr(prog, name, wrapped)


def request(run, i: int):
    batches = run.state["batches"]
    out = run.state["prog"].generate(batches[i % len(batches)], device=run.device)
    if run.fault == "alter" and i == 0:
        out[0, out.shape[1] // 2, 0] ^= 1
    elif run.fault == "half":
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half]
    elif run.fault == "stale" and i > 0:
        out = run.answers[-1]
    return out


def units(run, answer) -> int:
    return answer.shape[0]


def release(run) -> None:
    run.state.pop("prog", None)
    if run.device != "cpu":
        import torch

        torch.cuda.empty_cache()


def judge(run) -> dict:
    expected = run.state["expected"]
    wrong = 0
    for i, out in enumerate(run.answers):
        want = expected[i % len(expected)]
        if out.shape != want.shape:
            wrong += want.shape[0]
            continue
        wrong += int((out != want).reshape(want.shape[0], -1).any(axis=1).sum())
    run.state["failed"] = wrong
    return {"witnesses_wrong": {"value": wrong, "limit": 0}}


def failed(run) -> int:
    return run.state["failed"]
