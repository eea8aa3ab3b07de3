"""The proxy-side commands of ``demodel_tpu/cli.py``, on the port:

- ``demodel-tpu-torch`` (bare) and ``start`` — run the MITM caching proxy;
- ``init`` — create the root CA once and install it into the system
  trust store (failure is a warning);
- ``export-ca`` — print the CA's PEM, or install it for ``python-ssl``,
  ``python-certifi`` or ``openssl``;
- ``pull`` — pull a model through the store, ``--sink cuda`` also onto
  the card, ``--sharded`` straight off warm peers' manifests onto the
  card;
- ``gc`` — evict the store to a size cap;
- ``manifest`` — synthesize a model's manifest record from a
  client-warmed proxy cache, so the node can seed sharded pulls;
- ``serve`` — the whole node: the proxy (with ``/peer`` and the native
  tensor plane) and the ``/restore`` API, ``/metrics`` and ``/generate``
  on ``--restore-port``, over one store.

Configuration comes from the environment
(:meth:`~demodel_tpu_torch.config.ProxyConfig.from_env`). Run as
``python -m demodel_tpu_torch.cli <command>``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import ssl
import subprocess
import sys
from pathlib import Path

from demodel_tpu_torch.config import ProxyConfig


def _cmd_init(cfg: ProxyConfig, args) -> int:
    from demodel_tpu_torch import pki

    ca = pki.read_or_new_ca(cfg.data_dir, use_ecdsa=cfg.use_ecdsa)
    cert_path, _ = pki.ca_paths(cfg.data_dir)
    print(f"CA ready at {cert_path}", file=sys.stderr)
    install_system_trust(ca.cert_pem)
    return 0


def install_system_trust(pem: bytes) -> bool:
    """Install the CA into the OS trust store (Debian layout,
    ``/usr/local/share/ca-certificates``, then ``update-ca-certificates``)
    so clients on system roots trust the proxy; ``DEMODEL_TRUST_DIR``
    overrides the directory. Failure is a warning, never fatal; returns
    whether the system bundle was refreshed."""
    trust_dir = Path(os.environ.get(
        "DEMODEL_TRUST_DIR", "/usr/local/share/ca-certificates"))
    target = trust_dir / "demodel-tpu-ca.crt"
    try:
        trust_dir.mkdir(parents=True, exist_ok=True)
        target.write_bytes(pem)
    except OSError as e:
        print(f"trust-store: cannot write {target} ({e}); "
              "run as root or use `export-ca`", file=sys.stderr)
        return False
    try:
        subprocess.run(["update-ca-certificates"], capture_output=True,
                       text=True, check=True, timeout=60)
        print(f"trust-store: installed {target} (system bundle updated)",
              file=sys.stderr)
        return True
    except FileNotFoundError:
        print(f"trust-store: wrote {target}; update-ca-certificates not "
              "found — refresh the bundle with your distro's tool",
              file=sys.stderr)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        print(f"trust-store: wrote {target}; bundle refresh failed: {e}",
              file=sys.stderr)
    return False


def _cmd_export_ca(cfg: ProxyConfig, args) -> int:
    from demodel_tpu_torch import pki

    cert_path, _ = pki.ca_paths(cfg.data_dir)
    if not cert_path.exists():
        print("CA not initialized; run `init` first", file=sys.stderr)
        return 1
    pem = cert_path.read_bytes()
    if not args.for_:
        sys.stdout.write(pem.decode())
        return 0
    for preset in args.for_:
        {"python-ssl": _export_python_ssl,
         "python-certifi": _export_python_certifi,
         "openssl": _export_openssl}[preset](pem)
    return 0


def _export_python_ssl(pem: bytes) -> None:
    """Write the CA into ``ssl``'s default capath (or beside its cafile)."""
    paths = ssl.get_default_verify_paths()
    capath = paths.capath or (Path(paths.cafile).parent if paths.cafile
                              else None)
    if capath is None:
        print("python-ssl: no capath/cafile reported by ssl", file=sys.stderr)
        return
    target = Path(capath) / "demodel-ca.crt"
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_bytes(pem)
    print(f"python-ssl: wrote {target}", file=sys.stderr)


def _export_python_certifi(pem: bytes) -> None:
    """Append the CA to certifi's bundle once (skipped where certifi is
    absent). The bundle is found beside the package, not imported."""
    spec = importlib.util.find_spec("certifi")
    if spec is None or spec.origin is None:
        print("python-certifi: certifi not installed", file=sys.stderr)
        return
    bundle = Path(spec.origin).parent / "cacert.pem"
    if pem.strip() in bundle.read_bytes():
        print(f"python-certifi: already present in {bundle}", file=sys.stderr)
        return
    with open(bundle, "ab") as f:
        f.write(b"\n" + pem)
    print(f"python-certifi: appended to {bundle}", file=sys.stderr)


def _export_openssl(pem: bytes) -> None:
    """Install into OPENSSLDIR's ``certs/`` with the subject-hash link
    that ``openssl verify`` and libssl look up."""
    try:
        out = subprocess.run(["openssl", "version", "-d"],
                             capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"openssl: cannot locate OPENSSLDIR: {e}", file=sys.stderr)
        return
    # OPENSSLDIR: "/usr/lib/ssl"
    certs = Path(out.split(":", 1)[1].strip().strip('"')) / "certs"
    target = certs / "demodel-ca.crt"
    try:
        certs.mkdir(parents=True, exist_ok=True)
        target.write_bytes(pem)
        h = subprocess.run(
            ["openssl", "x509", "-subject_hash", "-noout"],
            input=pem, capture_output=True, check=True,
        ).stdout.decode().strip()
        link = certs / f"{h}.0"
        if not link.exists():
            link.symlink_to(target.name)
        print(f"openssl: installed {target} ({link.name})", file=sys.stderr)
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"openssl: install failed (need root?): {e}", file=sys.stderr)


def _cmd_start(cfg: ProxyConfig, args) -> int:
    from demodel_tpu_torch.proxy import ProxyServer

    # getattr: the bare invocation routes here with the root parser's
    # namespace, which has no serve_* attributes
    server = ProxyServer(cfg,
                         session_threads=getattr(args, "serve_threads", None),
                         session_queue=getattr(args, "serve_queue", None))
    server.start()
    print(f"demodel-tpu-torch proxy listening on {cfg.host}:{server.port} "
          f"(mitm_all={cfg.mitm_all} no_mitm={cfg.no_mitm} "
          f"hosts={cfg.mitm_hosts})", file=sys.stderr)
    try:
        server.wait()
    except KeyboardInterrupt:
        server.stop()
    return 0


def _cmd_serve(cfg: ProxyConfig, args) -> int:
    """The full node: the proxy, and the restore API over the same store,
    its tensor bytes served by the proxy's native plane."""
    from demodel_tpu_torch.delivery import open_store
    from demodel_tpu_torch.proxy import ProxyServer
    from demodel_tpu_torch.restore.server import (RestoreRegistry,
                                                  RestoreServer)

    proxy = ProxyServer(cfg, session_threads=args.serve_threads,
                        session_queue=args.serve_queue)
    proxy.start()
    store = restore = None
    try:
        store = open_store(cfg)
        registry = RestoreRegistry(store)
        registry.attach_native(proxy)
        restore = RestoreServer(registry, host=cfg.host,
                                port=args.restore_port, proxy=proxy)
        restore.start()
        print(f"demodel-tpu-torch node: proxy+peer on {cfg.host}:"
              f"{proxy.port}, restore API + /metrics on {cfg.host}:"
              f"{restore.port}", file=sys.stderr, flush=True)
        proxy.wait()
    except KeyboardInterrupt:
        pass
    finally:
        if restore is not None:
            restore.stop()
        proxy.stop()
        if store is not None:
            store.close()
    return 0


def _cmd_pull(cfg: ProxyConfig, args) -> int:
    try:
        if args.sharded:
            # straight off a warm peer's manifest onto the card: only the
            # byte windows this host places cross the wire
            if not args.peer:
                print("--sharded requires at least one --peer",
                      file=sys.stderr)
                return 2
            from demodel_tpu_torch.sink.remote import pull_manifest_to_hbm

            report, _placed = pull_manifest_to_hbm(args.model, args.peer,
                                                   source=args.source)
        else:
            from demodel_tpu_torch.delivery import pull_to_hbm

            report, _placed = pull_to_hbm(
                args.model, cfg, source=args.source, revision=args.revision,
                peers=args.peer or None, deliver=args.sink == "cuda")
    except Exception as e:  # noqa: BLE001 — CLI boundary: no raw tracebacks
        print(f"pull failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, indent=2, default=str))
    return 0


def _cmd_gc(cfg: ProxyConfig, args) -> int:
    """One store eviction to ``--max-gb`` (or ``DEMODEL_CACHE_MAX_GB``)."""
    from demodel_tpu_torch.delivery import open_store
    from demodel_tpu_torch.utils.env import env_int

    max_gb = args.max_gb or env_int("DEMODEL_CACHE_MAX_GB", 0)
    if max_gb <= 0:
        print("gc: no cap given (--max-gb or DEMODEL_CACHE_MAX_GB)",
              file=sys.stderr)
        return 2
    store = open_store(cfg)
    try:
        total, freed, evicted = store.gc(max_gb << 30)
    finally:
        store.close()
    print(json.dumps({"cap_gb": max_gb, "in_use_bytes": total,
                      "freed_bytes": freed, "evicted": evicted}))
    return 0


def _cmd_manifest(cfg: ProxyConfig, args) -> int:
    from demodel_tpu_torch.delivery import open_store, synthesize_manifest

    store = open_store(cfg)
    try:
        record = synthesize_manifest(store, args.model, source=args.source,
                                     include_private=args.include_private)
    except (FileNotFoundError, PermissionError) as e:
        print(str(e), file=sys.stderr)
        return 1
    finally:
        store.close()
    print(json.dumps(record, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="demodel-tpu-torch",
        description="Caching, syncing, distributing middleware for models "
        "and datasets, delivering onto CUDA devices. Bare invocation "
        "starts the proxy.")
    sub = p.add_subparsers(dest="cmd")
    st = sub.add_parser("start", help="run the MITM caching proxy")
    sv = sub.add_parser("serve", help="run proxy + peer + restore APIs")
    sv.add_argument("--restore-port", type=int, default=8081)
    for serving in (st, sv):
        # the session pool: an explicit flag wins over
        # DEMODEL_PROXY_THREADS / _QUEUE, then 2 × CPUs
        serving.add_argument("--serve-threads", type=int, default=None,
                             help="session worker pool size (default: "
                                  "DEMODEL_PROXY_THREADS or 2×CPUs)")
        serving.add_argument("--serve-queue", type=int, default=None,
                             help="accept-queue bound; overflow is "
                                  "answered 503 + Retry-After (default: "
                                  "DEMODEL_PROXY_QUEUE or 4×pool)")
    sub.add_parser("init", help="create the root CA")
    e = sub.add_parser("export-ca", help="export/install the root CA")
    e.add_argument("--for", dest="for_", action="append", default=[],
                   choices=["python-ssl", "python-certifi", "openssl"],
                   help="trust-store preset (repeatable)")
    pl = sub.add_parser("pull", help="pull a model through the cache")
    pl.add_argument("model")
    pl.add_argument("--source", default="hf", choices=["hf", "ollama"])
    pl.add_argument("--sink", default="cache", choices=["cache", "cuda"],
                    help="cuda: also stream the weights onto the card")
    pl.add_argument("--revision", default="main")
    pl.add_argument("--peer", action="append", default=[],
                    help="peer node base URL tried before upstream "
                         "(repeatable)")
    pl.add_argument("--sharded", action="store_true",
                    help="read only the placed byte windows off warm "
                         "peers' manifest, straight onto the card "
                         "(requires --peer)")
    g = sub.add_parser("gc", help="evict LRU cache entries to a size cap")
    g.add_argument("--max-gb", type=int, default=0)
    mf = sub.add_parser(
        "manifest",
        help="synthesize a model manifest from the proxy-warmed cache "
             "(lets a foreign-client-warmed node seed sharded pulls)")
    mf.add_argument("model")
    mf.add_argument("--source", default="hf", choices=["hf", "ollama"])
    mf.add_argument(
        "--include-private", action="store_true",
        help="explicitly republish auth-scoped (gated-repo) cache "
             "entries under public peer-servable keys; without this, "
             "gated bytes are omitted from the synthesized manifest")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = ProxyConfig.from_env()
    return {"init": _cmd_init, "export-ca": _cmd_export_ca,
            "pull": _cmd_pull, "gc": _cmd_gc, "manifest": _cmd_manifest,
            "serve": _cmd_serve}.get(args.cmd, _cmd_start)(cfg, args)


if __name__ == "__main__":
    sys.exit(main())
