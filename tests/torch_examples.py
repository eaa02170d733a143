"""The examples' twins (``examples/*_torch.py``) as the tests and
``chip_smoke.py`` phase 22 drive them: load a twin from ``examples/`` (no
package), derive the kernel launches of a run from the settings its own
parser reads (``launches``), and run its ``main`` on the CPU, holding its
output lines and its launches."""
import importlib.util
from pathlib import Path

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("quickstart_torch", "serve_batched_torch",
         "federated_llm_pretrain_torch", "malicious_client_ablation_torch",
         "privacy_attack_torch")


def load(name: str):
    """An example's twin as a module (``examples/`` is no package)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _evaluations(rounds: int, every: int) -> int:
    """``run_federated``'s evaluations: every ``every`` rounds and after
    the last."""
    return len({r for r in range(1, rounds + 1)
                if r % every == 0 or r == rounds})


def _ctgan(*, clients: int, rounds: int, steps: int, runs: int = 1,
           setups: int | None = None, encodes: int = 0, decodes: int = 0,
           probe: bool = False) -> dict:
    """The kernel launches of ``runs`` federated CTGAN runs of ``clients``
    x ``rounds`` x ``steps``: a merge a round; an activation backward a
    client and step (the G step) and a forward for it and for the D step;
    a forward and a table decode per synthesis (``decodes``); an encode a
    client and setup (the §4.1 split's tables; a setup a run unless
    ``setups`` says), ``encodes`` more.  ``probe``: one more round of one
    step on every client, with its merge."""
    bwd = runs * clients * rounds * steps + (clients if probe else 0)
    out = {"weighted_agg": runs * rounds + int(probe),
           "segment_activations_bwd": bwd,
           "segment_activations": 2 * bwd + decodes,
           "vgm_encode_table": (runs if setups is None else setups) * clients
           + encodes}
    if decodes:
        out["vgm_decode_table"] = decodes
    return out


def launches(name: str, argv) -> dict:
    """The card's kernel launches of twin ``name``'s ``main(argv)``, keyed
    by kernel, from the settings its parser reads; the counts the twins and
    the library fix (clients, local steps, the evaluation cadence) are
    theirs, written once here."""
    a = load(name).parse(list(argv))
    if name == "quickstart_torch":
        # 3 clients x 2 local steps; the evaluations and the 5 sampled rows
        return _ctgan(clients=3, rounds=a.rounds, steps=2,
                      decodes=_evaluations(a.rounds, 4) + 1)
    if name == "serve_batched_torch" and a.tabular:
        from repro_torch.serve import ladder_from_sizes
        sizes = tuple(int(s) for s in a.sizes.split(","))
        # run_tabular_server's warm-up (3 clients x 2 local steps) and the
        # registered table's encode; a decode per warmed bucket and per
        # request
        return _ctgan(clients=3, rounds=a.rounds, steps=2, encodes=1,
                      decodes=len(ladder_from_sizes(sizes).buckets)
                      + a.requests)
    if name == "serve_batched_torch":
        from repro_torch.configs import get_smoke_config
        # one chunkwise prefill per mLSTM layer; attention and the decode
        # steps reach no kernel at the smoke configs (no flash kernel)
        cfg = get_smoke_config(a.arch)
        assert not cfg.use_flash_kernel, cfg.name
        n = sum(kind == "mlstm" for kind in cfg.block_kinds())
        return {"mlstm_chunk": n} if n else {}
    if name == "federated_llm_pretrain_torch":
        # a merge a round; smollm's smoke config reaches no flash kernel
        return {"weighted_agg": a.rounds}
    if name == "malicious_client_ablation_torch":
        # clean, attacked and defended, each evaluated every rounds // 2;
        # the probe's round on a fourth setup; --host adds the per-round
        # host oracle's run, which merges per leaf (no weighted_agg)
        every = max(a.rounds // 2, 1)
        out = _ctgan(clients=a.clients, rounds=a.rounds, steps=1, runs=3,
                     setups=4, decodes=3 * _evaluations(a.rounds, every),
                     probe=True)
        if a.host:
            host = _ctgan(clients=a.clients, rounds=a.rounds, steps=1,
                          decodes=_evaluations(a.rounds, every))
            host.pop("weighted_agg")
            out = {k: out.get(k, 0) + host.get(k, 0)
                   for k in out.keys() | host.keys()}
        return out
    if name == "privacy_attack_torch":
        # the traced and the DP run (2 clients); each of the two membership
        # attacks and the null calibration encodes 2 x 2 candidate sets a
        # recorded round
        return _ctgan(clients=2, rounds=a.rounds, steps=a.local_steps,
                      runs=2, encodes=3 * 2 * 2 * a.rounds)
    raise KeyError(name)


def plain_launches(card: dict) -> dict:
    """The counts the CPU's plain route gives for the card's ``card``
    launches: ``<kernel>_ref``, but the activation backward, which is
    autograd's there, uncounted."""
    return {k + "_ref": n for k, n in card.items()
            if n and k != "segment_activations_bwd"}


def run_on_cpu(name: str, argv: list, lines: list, capsys,
               returns=(None,)) -> str:
    """``main(argv + ["--device", "cpu"])``: every line of ``lines`` in its
    output, its return value in ``returns``, and its launches exactly
    those ``launches`` derives, on the plain route."""
    with ops.dispatch_scope() as counts:
        rc = load(name).main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, f"{name}: no {line!r} in\n{out}"
    assert rc in returns, rc
    want = plain_launches(launches(name, argv + ["--device", "cpu"]))
    assert {k: n for k, n in counts.items() if n} == want, (dict(counts),
                                                            want)
    return out
