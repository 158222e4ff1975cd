#!/usr/bin/env python
"""Launch a multi-process job (the port's counterpart of the reference's
``tools/launch.py``; ref: tools/launch.py and dmlc_tracker's local and
ssh launchers).

    python -m mxnet_tpu_torch.tools.launch -n 2 [--cpu-devices N] \\
        python train.py ...

Every process is a worker (there are no scheduler or server roles) and
rank 0 serves the rendezvous store. Each worker gets the ``DMLC_*``
environment the reference's tracker sets:

    DMLC_PS_ROOT_URI / DMLC_PS_ROOT_PORT   the rendezvous address
    DMLC_NUM_WORKER                        the number of workers
    DMLC_WORKER_ID                         this worker's rank
    DMLC_ROLE=worker

``--cpu-devices N`` gives each worker N CPU contexts
(``MXNET_DIST_CPU_DEVICES``), which puts the group on gloo. When a
worker fails the launcher stops the others (they would wait in their
next collective) and exits with the failure's code; a SIGTERM to the
launcher stops every worker too. Launchers: ``local`` (N workers on
this host) and ``ssh`` (one worker a host of ``--host-file``).
``-s/--num-servers`` is accepted for the reference's command line and
must be 0.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env(args, worker_id: int, uri: str, port: int):
    env = dict(os.environ)
    env.update({
        "DMLC_ROLE": "worker",
        "DMLC_PS_ROOT_URI": uri,
        "DMLC_PS_ROOT_PORT": str(port),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": "0",
        "DMLC_WORKER_ID": str(worker_id),
    })
    if args.cpu_devices:
        env["MXNET_DIST_CPU_DEVICES"] = str(args.cpu_devices)
    return env


def _stop(procs, grace: float = 10.0):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    end = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _wait_all(procs) -> int:
    """Wait for every worker; when one fails, stop the rest."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return max(abs(c) for c in codes) if any(codes) else 0
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                time.sleep(1.0)   # a grace for siblings to exit alone
                _stop(procs)
                return abs(failed[0]) or 1
            time.sleep(0.05)
    finally:
        _stop(procs)


def _on_sigterm(signum, frame):
    raise SystemExit(128 + signum)


def launch_local(args, command) -> int:
    uri, port = "127.0.0.1", _free_port()
    procs = []
    try:
        for wid in range(args.num_workers):
            procs.append(subprocess.Popen(
                command, env=_worker_env(args, wid, uri, port)))
    except BaseException:
        _stop(procs, grace=0.0)   # no half a rendezvous left behind
        raise
    return _wait_all(procs)


def launch_ssh(args, command) -> int:
    with open(args.host_file) as f:
        hosts = [h.strip() for h in f if h.strip() and not h.startswith("#")]
    if len(hosts) < args.num_workers:
        raise SystemExit("host file has %d hosts < -n %d"
                         % (len(hosts), args.num_workers))
    uri = hosts[0]
    port = args.port or 9091
    procs = []
    cwd = os.getcwd()
    for wid in range(args.num_workers):
        env = _worker_env(args, wid, uri, port)
        exports = " ".join("%s=%s" % (k, v) for k, v in env.items()
                           if k.startswith(("DMLC_", "MXNET_")))
        remote = "cd %s && env %s %s" % (cwd, exports, " ".join(command))
        procs.append(subprocess.Popen(["ssh", "-o",
                                       "StrictHostKeyChecking=no",
                                       hosts[wid], remote]))
    return _wait_all(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="launch a multi-process mxnet_tpu_torch job")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for the reference's command line; "
                         "must be 0")
    ap.add_argument("--launcher", choices=["local", "ssh"], default="local")
    ap.add_argument("-H", "--host-file", help="one host a line (ssh)")
    ap.add_argument("--port", type=int, help="rendezvous port (ssh)")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="CPU contexts a worker (puts the group on gloo)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.num_servers:
        raise SystemExit(
            "-s/--num-servers must be 0: there are no parameter-server "
            "processes (every process is a worker; see "
            "mxnet_tpu_torch.dist)")
    if not args.command:
        raise SystemExit("no command given")
    signal.signal(signal.SIGTERM, _on_sigterm)
    if args.launcher == "local":
        return launch_local(args, args.command)
    if not args.host_file:
        raise SystemExit("ssh launcher needs --host-file")
    return launch_ssh(args, args.command)


if __name__ == "__main__":
    sys.exit(main())
