"""``examples/malicious_client_ablation_torch.py`` on the CPU, with
``--host``: the guard's verdicts, the three runs' quality lines, and the
one-program run against the per-round host oracle at its reference's
tolerance, and its launches as ``torch_examples.launches`` derives them.  It needs 3 clients (with 2 the norm guard's median is the
byzantine client's own).  Its cost is the §4.1 setup on ``intrusion``
(22 continuous columns, each global VGM fitted to 20,000 draws), five
times; rows and rounds barely move it.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_examples import run_on_cpu  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_malicious_client_ablation_runs_on_the_cpu(capsys):
    run_on_cpu(
        "malicious_client_ablation_torch",
        ["--rows", "300", "--clients", "3", "--rounds", "2", "--host"],
        ["guard verdicts (client 2 is byzantine, scale=64):",
         "client_ok = [1, 1, 0]", "final quality (lower is better):",
         "clean     jsd=", "attacked  jsd=", "defended  jsd=",
         "defended vs clean jsd ratio:",
         "one-program == host-loop generator (ulp-tight): True"], capsys)
