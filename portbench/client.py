"""The closed-loop HTTP clients of a serving cell, run as a child process
of the run so that their Python does not share the server's interpreter
lock.

    python3 -m portbench.client

It reads one JSON object on standard input (``url``, ``traffic``,
``seed``, ``vocab``), builds the same plan as the run
(``traffic.serve_plan``), prints ``ready``, and waits for a line
``<t0> <deadline>`` in ``time.monotonic()`` seconds, which the run and
this process share.  Client ``c`` sends its first request at ``t0 + c *
stagger_s`` and each next one when the previous answer is back, until
the deadline; then it sends nothing more and waits for the answer in
flight, up to ``DRAIN_S`` past the deadline.  It prints one JSON line,
each sent request's client, index, send time, and once answered its done
time, HTTP status and tokens, and exits: a request not answered by then
(done null) is left to the server's shutdown.
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
import urllib.parse

from portbench.traffic import serve_plan

REQUEST_TIMEOUT_S = 900.0
# how long past the deadline the requests in flight there may take
DRAIN_S = 150.0


def _client(c: int, reqs: list, host: str, port: int, t0: float,
            deadline: float, stagger: float, out: list) -> None:
    conn = http.client.HTTPConnection(host, port, timeout=REQUEST_TIMEOUT_S)
    start = t0 + c * stagger
    while time.monotonic() < start:
        time.sleep(min(0.01, max(0.0, start - time.monotonic())))
    try:
        for i, r in enumerate(reqs):
            if time.monotonic() >= deadline:
                break
            body = json.dumps({"tokens": r["prompt"],
                               "max_new_tokens": r["max_new"]}).encode()
            rec = {"c": c, "i": i, "send": time.monotonic(), "status": None,
                   "done": None}
            out.append(rec)
            try:
                conn.request("POST", "/v1/generate", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
                rec["status"] = resp.status
                rec["tokens"] = json.loads(payload).get("tokens") \
                    if resp.status == 200 else None
            except (OSError, http.client.HTTPException, ValueError) as e:
                rec["status"] = 0
                rec["error"] = repr(e)[:200]
                conn.close()
                conn = http.client.HTTPConnection(
                    host, port, timeout=REQUEST_TIMEOUT_S)
            rec["done"] = time.monotonic()
    finally:
        conn.close()


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    traffic = spec["traffic"]
    plan = serve_plan(traffic, spec["seed"], spec["vocab"])
    url = urllib.parse.urlsplit(spec["url"])
    print("ready", flush=True)
    t0, deadline = (float(x) for x in sys.stdin.readline().split())
    out: list = []
    threads = [threading.Thread(
        target=_client, args=(c, reqs, url.hostname, url.port, t0, deadline,
                              traffic.get("stagger_s", 0.0), out),
        name=f"client-{c}", daemon=True) for c, reqs in enumerate(plan)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, deadline + DRAIN_S - time.monotonic()))
    print(json.dumps([dict(r) for r in list(out)]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
