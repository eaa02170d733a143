"""Each kind of cell run end to end on the CPU at a small size: the
program checks out correct against the plain reference, and the run
reports what the manifest says the cell reports.  ``intrusion.train``
runs ``adult.train``'s code on another schema; its 22 continuous columns
make its protocol too slow for the CPU suite, and the card test runs it."""
import json

import pytest

from _small import ROOT, run_small

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", ["adult.train", "adult.serve",
                                  "intrusion.bulk"])
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "compared"
    # the CPU has no device trace: the device's metrics are left out
    want = {m["name"] for m in MAN["end_to_end"]
            if ("workloads" not in m or cell in m["workloads"])
            and m["source"] != "device_trace"}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        assert m["value"] > 0, name
