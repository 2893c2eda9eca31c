"""The traffic, the statistics and the manifest's names, on the CPU."""

import json
import math
import re

import numpy as np
import pytest

from benchmark import cell, readers, traffic

MAN = cell.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _phi(x):
    return 0.5 * (1 + math.erf(x / math.sqrt(2)))


@pytest.mark.parametrize("mix", ["train_mix", "serve_cohort"])
def test_draws_repeat_and_follow_the_lognormal(mix):
    m = traffic.load(mix)
    a, b = traffic.slide_lengths(m), traffic.slide_lengths(m)
    assert np.array_equal(a, b) and a.min() >= m["min_len"] and a.max() <= m["max_len"]
    buckets = [2048, 4096, 8192, 16384, 32768]
    cdf = [_phi((math.log(x) - math.log(m["median"])) / m["sigma"]) for x in buckets[:-1]] + [1.0]
    want = np.diff([0.0] + cdf)
    got = np.array(list(traffic.bucket_shares(a, buckets).values()))
    assert np.abs(got - want).max() < 0.03, (got, want)


def test_seed_orders_the_same_work():
    m = traffic.load("train_mix")
    lens = traffic.slide_lengths(m)
    p1 = traffic.batch_plan(lens, m["buckets"], 4, traffic.sub_seed(2 ** 40 + 3, 2))
    p2 = traffic.batch_plan(lens, m["buckets"], 4, traffic.sub_seed(2 ** 40 + 3, 2))
    p3 = traffic.batch_plan(lens, m["buckets"], 4, traffic.sub_seed(7, 2))
    assert p1 == p2 and p1 != p3
    assert sorted(c["bucket"] for c in p1) == sorted(c["bucket"] for c in p3)
    assert sorted(i for c in p1 for i in c["slides"]) == list(range(len(lens)))
    for i, j in zip(traffic.pass_orders(33, 5, 3), traffic.pass_orders(33, 5, 3)):
        assert np.array_equal(i, j) and sorted(i) == list(range(33))
    assert 0 <= traffic.sub_seed(2 ** 40, 1) < 2 ** 63 and traffic.sub_seed(1, 1) != traffic.sub_seed(1, 2)


@pytest.mark.parametrize("arrivals", ["even", "gamma"])
def test_arrivals_offer_the_rate_in_seeded_orders(arrivals):
    m = {"rate_per_s": 28, "sizes_seed": 353, "arrivals": arrivals, "cv": 2.0}
    a, b, c = (traffic.pass_gaps(m, 64, s) for s in (2 ** 40 + 3, 2 ** 40 + 3, 7))
    assert np.array_equal(a, b) and np.allclose(np.sort(a), np.sort(c)) and a.sum() == pytest.approx(64 / 28)
    if arrivals == "gamma":  # bursts: gaps far more uneven than a Poisson process's
        assert not np.array_equal(a, c) and a.std() / a.mean() > 1.5
    else:
        assert np.all(a == 1 / 28)


def test_rates_are_all_work_over_all_time():
    run = cell.Run("w", "train", {}, {}, window_s=10.0, bags=400)
    assert readers.bags_per_s(run) == 40.0
    lat = [10.0] * 90 + [1000.0] * 10  # a stall in the tail counts
    run = cell.Run("w", "serve", {}, {}, latencies_ms=lat)
    assert readers.p95_ms(run) == pytest.approx(np.percentile(lat, 95)) and readers.p95_ms(run) > 900


def test_manifest_names_files_and_bounds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [c["name"] for c in MAN["workloads"] + MAN["configs"]]
    assert len(names) == len(set(names))
    for n in names + [c["traffic"] for c in MAN["workloads"]]:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (cell.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and all(w in {c["name"] for c in MAN["workloads"]} for w in m["workloads"])
    for c in MAN["workloads"]:
        assert (cell.HERE / "traffic" / f"{c['traffic']}.json").exists()
        assert (cell.HERE / "limits" / f"{c['name']}.json").exists()
        got = [m["name"] for m in cell.cell_metrics(MAN, c["name"], False)]
        assert "setup_s" in got and len(got) >= 2 and cell.cell_metrics(MAN, c["name"], True)
    for c in MAN["configs"]:
        conf = json.loads((cell.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and (cell.HERE / "reference" / f"{conf['reference']}.py").exists()
