"""The serving cells' open-loop client, run as a process of its own so that
its threads take no interpreter time from the server's dispatcher.

    python3 benchmark/harness/client.py < job.json > results.json

The job is ``{"url", "pool", "dues", "picks", "tag"}``: request i posts the
one item ``pool[picks[i]]`` (its ``route_index`` made unique with ``tag``)
at ``dues[i]`` seconds after the client's start. The results are, per
request, ``[due, sent, done, records or null]`` in seconds on the client's
clock. Standard library only.
"""

from __future__ import annotations

import json
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

CLIENT_THREADS = 64


def post(url, obj, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def offer(url, pool, dues, picks, tag):
    """Post request i at ``t0 + dues[i]``; per request ``(due, sent, done,
    records or None)`` in seconds from t0."""
    out = [None] * len(dues)

    def send(i, t0):
        sent = time.perf_counter() - t0
        item = dict(pool[picks[i]], route_index=f"{tag}{i}_1")
        try:
            recs = post(url, {"items": [item]})["predictions"]
            if len(recs) != 1:
                raise RuntimeError("a reply lost its item")
        except Exception as e:  # a miss: counted by the caller, named here
            print(f"[serve] request {i} failed: {e!r}", file=sys.stderr)
            recs = None
        out[i] = (dues[i], sent, time.perf_counter() - t0, recs)

    with ThreadPoolExecutor(max_workers=CLIENT_THREADS) as ex:
        t0 = time.perf_counter()
        futures = []
        for i, due in enumerate(dues):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(ex.submit(send, i, t0))
        for f in futures:
            f.result()
    return out


if __name__ == "__main__":
    job = json.load(sys.stdin)
    json.dump(offer(job["url"], job["pool"], job["dues"], job["picks"], job["tag"]),
              sys.stdout)
