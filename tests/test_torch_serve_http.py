"""The port's HTTP front-end (``avdn_tpu_torch.serve_http``) over its
Navigator on the CPU: the counterparts of ``tests/test_serve_http.py``'s
eight tests, plus a request of 2.5 × ``serve_batch`` items (split into
batches, answered once, in order), ``Navigator.from_args`` and the phase
timers.

The Navigator is the fixture dataset's tiny model (demb 64, the tiny
Darknet, T = 2, fp32, the exact render) from the seed's random weights, at
``serve_batch`` 4. Where a request's items make up the same batches as a
``navigate()`` call of the same items, its predictions over HTTP equal
``navigate()``'s exactly (``tests/test_torch_serve.py`` holds ``navigate()``
against the JAX package's).
"""

import http.client
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_e2e_loop import make_args
from torch_shared import fixture_dataset, port_argv

SERVE_BATCH = 4


def _argv(root, cfg_path, out):
    args = make_args(root, out, cfg_path, render_twopass=False, bf16=False)
    return port_argv(args) + ["--bf16", "False"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A live HTTP server on a free port over the tiny Navigator."""
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.serve_http import make_server

    root, cfg_path = fixture_dataset(tmp_path_factory)
    argv = _argv(root, cfg_path, str(tmp_path_factory.mktemp("serve_http") / "out"))
    nav = Navigator.from_args(argv, serve_batch=SERVE_BATCH, device="cpu")
    server = make_server(nav, host="127.0.0.1", port=0, max_wait_ms=300.0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        yield base, server, root, argv
    finally:
        server.shutdown()
        server.service.close()
        t.join(timeout=30)
        assert not t.is_alive()


def _items(root, split):
    with open(os.path.join(root, "AVDN", "annotations", f"{split}_data.json")) as f:
        return json.load(f)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _concurrently(fn, n):
    ts = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
        assert not t.is_alive()


def _assert_equal_to_navigate(nav, items, recs):
    """The HTTP records equal ``nav.navigate(items)``'s, item for item."""
    want = nav.navigate(items)
    assert len(recs) == len(items)
    for it, rec in zip(items, recs):
        key = it["map_name"] + "__" + it["route_index"]
        assert rec["instr_id"] == key
        w = want[key]
        assert len(rec["path_corners"]) == len(w["path_corners"]), key
        for (gc, gd), (wc, wd) in zip(rec["path_corners"], w["path_corners"]):
            np.testing.assert_array_equal(np.asarray(gc), np.asarray(wc))
            assert gd == float(wd)
        for (gwp, galt), (wwp, walt) in zip(rec["actions"], w["actions"]):
            np.testing.assert_array_equal(np.asarray(gwp), np.asarray(wwp))
            assert galt == float(walt)
        np.testing.assert_array_equal(np.asarray(rec["progress"]),
                                      np.asarray(w["progress"]))


def test_healthz(served):
    base, server, root, _ = served
    code, body = _get(base + "/healthz")
    assert code == 200
    assert body["status"] == "ok" and body["family"] == "et"
    assert body["serve_batch"] == SERVE_BATCH


def test_navigate_order_ids_and_json_shapes(served):
    base, server, root, _ = served
    items = _items(root, "val_seen")[:2]
    code, body = _post(base + "/navigate", {"items": items})
    assert code == 200
    preds = body["predictions"]
    assert len(preds) == 2
    # request order kept, the client's instr_ids restored
    for it, rec in zip(items, preds):
        assert rec["instr_id"] == it["map_name"] + "__" + it["route_index"]
    corners0, heading0 = preds[0]["path_corners"][0]
    assert np.asarray(corners0).shape == (4, 2)  # JSON lists, not numpy
    assert isinstance(heading0, (int, float))
    assert isinstance(preds[0]["actions"], list)
    _assert_equal_to_navigate(server.service.nav, items, preds)


def test_concurrent_requests_coalesce_into_one_batch(served):
    """4 concurrent single-item posts inside the 300 ms window run as one
    batch (serve_batch 4), each reply carrying its own item."""
    base, server, root, _ = served
    items = _items(root, "train")[:4]
    results = [None] * 4
    before = server.service.batches_run

    def go(i):
        it = dict(items[i], route_index=f"77_{i + 1}")
        results[i] = _post(base + "/navigate", {"items": [it]})

    _concurrently(go, 4)
    for i, (code, body) in enumerate(results):
        assert code == 200
        assert len(body["predictions"]) == 1
        assert body["predictions"][0]["instr_id"] == items[i]["map_name"] + f"__77_{i + 1}"
    # all four in one (at worst two) coalesced batches
    assert server.service.batches_run - before <= 2


def test_burst_pipelines_multiple_batches(served):
    """6 concurrent requests of 2 items (12 items, serve_batch 4) take the
    dispatcher through at least 3 batches, each launched before the one
    before it is answered; every reply carries its own items, in order."""
    base, server, root, _ = served
    items = _items(root, "train")
    before = server.service.batches_run
    results = [None] * 6

    def go(i):
        reqs = [dict(items[(i + k) % len(items)], route_index=f"b{i}_{k + 1}")
                for k in range(2)]
        results[i] = _post(base + "/navigate", {"items": reqs})

    _concurrently(go, 6)
    for i, (code, body) in enumerate(results):
        assert code == 200
        assert len(body["predictions"]) == 2
        for k, rec in enumerate(body["predictions"]):
            assert rec["instr_id"] == items[(i + k) % len(items)]["map_name"] + f"__b{i}_{k + 1}"
    assert server.service.batches_run - before >= 3


def test_duplicate_route_index_across_requests(served):
    """Two concurrent requests with the same route_index do not cross-wire:
    the service tags ids per request before merging."""
    base, server, root, _ = served
    raw = _items(root, "train")[0]
    a = dict(raw, instructions="fly north")
    b = dict(raw, instructions="fly south to the red building")
    out = [None, None]

    def go(i):
        out[i] = _post(base + "/navigate", {"items": [(a, b)[i]]})

    _concurrently(go, 2)
    same_id = raw["map_name"] + "__" + raw["route_index"]
    for code, body in out:
        assert code == 200
        assert len(body["predictions"]) == 1
        assert body["predictions"][0]["instr_id"] == same_id


def test_bad_requests(served):
    base, server, root, _ = served
    code, body = _post(base + "/navigate", {"nope": 1})
    assert code == 400 and "error" in body
    code, body = _post(base + "/navigate", {"items": "not-a-list"})
    assert code == 400
    code, body = _get(base + "/nothing")
    assert code == 404
    # a malformed item is the client's fault: 400 naming the item
    code, body = _post(base + "/navigate", {"items": [{"instructions": "no map fields"}]})
    assert code == 400 and "item 0" in body["error"]
    code, body = _post(base + "/navigate", {"items": [17]})
    assert code == 400 and "item 0" in body["error"]


def test_request_caps_413(served):
    """A declared 100 MB body is refused before any byte is read, and more
    items than max_items before any validation."""
    base, server, root, _ = served
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/navigate")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(100 * 1024 * 1024))
        conn.endheaders()
        resp = conn.getresponse()
        body = json.loads(resp.read())
    finally:
        conn.close()
    assert resp.status == 413 and "limit" in body["error"]
    code, body = _post(base + "/navigate", {"items": [{}] * 1025})
    assert code == 413 and "1025 items" in body["error"]


def test_empty_items_ok(served):
    base, server, root, _ = served
    code, body = _post(base + "/navigate", {"items": []})
    assert code == 200 and body["predictions"] == []


def test_oversized_request_is_split_and_answered_in_order(served):
    """One request of 2.5 × serve_batch items runs as three batches (4, 4
    and 2 padded) and is answered once, in request order, with what
    ``navigate()`` gives for the same items (the same three batches)."""
    base, server, root, _ = served
    pool = _items(root, "val_seen")
    items = [dict(pool[k % len(pool)], route_index=f"big{k}_1")
             for k in range(5 * SERVE_BATCH // 2)]
    before = server.service.batches_run
    code, body = _post(base + "/navigate", {"items": items})
    assert code == 200
    assert server.service.batches_run - before == 3
    _assert_equal_to_navigate(server.service.nav, items, body["predictions"])


def test_from_args_builds_the_same_navigator(served):
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.serve import Navigator

    _, server, _, argv = served
    nav = server.service.nav
    other = Navigator(parse_args(argv), serve_batch=SERVE_BATCH, device="cpu")
    assert vars(other.args) == vars(nav.args)
    assert other.serve_batch == nav.serve_batch and other.cfg == nav.cfg
    for mine, theirs in zip((nav.bert, nav.darknet, nav.vln),
                            (other.bert, other.darknet, other.vln)):
        sd = theirs.state_dict()
        for name, t in mine.state_dict().items():
            assert t.equal(sd[name]), name


def test_timers_see_each_phase_once_per_batch(served):
    from avdn_tpu_torch.utils.logging import PhaseTimer

    base, server, root, _ = served
    nav = server.service.nav
    items = [dict(it, route_index=f"t{k}_1")
             for k, it in enumerate(_items(root, "val_seen")[:2 * SERVE_BATCH])]
    nav.timers = PhaseTimer()
    before = server.service.batches_run
    code, _ = _post(base + "/navigate", {"items": items})
    assert code == 200
    batches = server.service.batches_run - before
    assert batches == 2
    phases = ("map_bank", "batch_build", "device_place", "dispatch", "device_wait",
              "assemble")
    assert dict(nav.timers.counts) == {p: batches for p in phases}
    assert all(nav.timers.totals[p] > 0 for p in phases)
