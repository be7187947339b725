"""API aggregation — the server chain's front door.

Reference: ``cmd/kube-apiserver/app/server.go`` ``CreateServerChain``:
requests enter the AGGREGATOR (kube-aggregator), which proxies any group
claimed by an ``APIService`` object to its backing extension apiserver and
DELEGATES everything else down the chain (kube-apiserver -> apiextensions
-> notfound). Here the chain is: aggregator -> core APIServer — an
``APIService`` (apiregistration.k8s.io/v1) whose spec names a group/version
and a service URL gets its ``/apis/<group>/<version>/...`` traffic proxied
verbatim (headers, body, status); everything else falls through to the
wrapped core server's handler, byte-for-byte.

``availability``: a backend that refuses connections marks the APIService
Unavailable (503 to callers), mirroring the aggregator's availability
controller.
"""

from __future__ import annotations

import http.client
import threading
from http.server import BaseHTTPRequestHandler
from typing import Optional
from urllib.parse import urlsplit, urlparse

from kubernetes_tpu_torch.store.apiserver import APIServer, _HTTPServer

APISERVICE_KIND = "APIService"

# hop-by-hop headers a proxy must not forward (RFC 7230 §6.1)
_HOP = {"connection", "keep-alive", "transfer-encoding", "te", "upgrade",
        "proxy-authenticate", "proxy-authorization", "trailers"}


class AggregatedAPIServer:
    """The aggregator in front of a core APIServer.

    ``core``: an APIServer instance (NOT started — the aggregator serves
    its handler in-process as the delegate, exactly like the reference's
    delegation chain shares one mux). APIService objects are stored in the
    core store under kind ``APIService``; ``register_api_service`` is the
    convenience used by tests/CLI."""

    def __init__(self, core: Optional[APIServer] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.core = core or APIServer()
        aggregator = self

        core_handler = self.core._make_handler()

        class Handler(core_handler):
            def _aggregate(self) -> bool:
                """True when the request was proxied to an APIService."""
                parts = [p for p in urlparse(self.path).path.split("/")
                         if p]
                if len(parts) < 3 or parts[0] != "apis":
                    return False
                group, version = parts[1], parts[2]
                svc = aggregator._service_for(group, version)
                if svc is None:
                    return False
                aggregator._proxy(self, svc)
                return True

            def _shaped(self, verb, fn):
                # aggregation happens INSIDE the filter chain: authn, APF
                # and audit run before any proxying (the reference
                # aggregator authenticates before dispatching; authorization
                # of aggregated resources is the backend's job, as upstream
                # forwards user info for the extension server to authorize)
                def fn_or_proxy():
                    if self._aggregate():
                        return None
                    return fn()
                return super()._shaped(verb, fn_or_proxy)

        self._httpd = _HTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # APIService map maintained from a store watch (informer analog)
        self._svc_lock = threading.Lock()
        self._svc_map: dict[tuple, str] = {}
        self._svc_watch = self.core.store.watch(APISERVICE_KIND, since_rv=0)

    # ---- APIService registry --------------------------------------------

    def register_api_service(self, group: str, version: str, url: str,
                             name: Optional[str] = None) -> dict:
        obj = {
            "kind": APISERVICE_KIND,
            "metadata": {"name": name or f"{version}.{group}"},
            "spec": {"group": group, "version": version,
                     "service": {"url": url}},
        }
        return self.core.store.create(APISERVICE_KIND, obj)

    def _service_for(self, group: str, version: str) -> Optional[str]:
        """(group, version) -> backend url, from a watch-maintained map —
        the hot request path must not pay a store list per request (the
        reference's APIService informer cache)."""
        with self._svc_lock:
            while True:
                ev = self._svc_watch.get(timeout=0)
                if ev is None:
                    break
                spec = ev.object.get("spec") or {}
                key = (spec.get("group"), spec.get("version"))
                if ev.type == "DELETED":
                    self._svc_map.pop(key, None)
                else:
                    self._svc_map[key] = (spec.get("service")
                                          or {}).get("url")
            if not self._svc_map:
                return None
            return self._svc_map.get((group, version))

    # ---- proxy -----------------------------------------------------------

    def _proxy(self, handler: BaseHTTPRequestHandler, url: str) -> None:
        parts = urlsplit(url)
        n = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(n) if n else None
        handler._body_consumed = True
        streaming = "watch=true" in handler.path
        try:
            conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                              timeout=30.0)
            fwd = {k: v for k, v in handler.headers.items()
                   if k.lower() not in _HOP and k.lower() != "host"}
            conn.request(handler.command, handler.path, body=body,
                         headers=fwd)
            resp = conn.getresponse()
            payload = None if streaming else resp.read()
        except OSError:
            # availability controller analog: unreachable backend -> 503
            body = (b'{"kind":"Status","status":"Failure","message":'
                    b'"APIService backend unavailable","code":503}')
            handler.send_response(503)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
            return
        handler.send_response(resp.status)
        for k, v in resp.getheaders():
            if k.lower() not in _HOP and k.lower() != "content-length":
                handler.send_header(k, v)
        if streaming:
            # watch: relay the unterminated chunked stream incrementally —
            # buffering would hang forever on heartbeats
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()
            try:
                while True:
                    data = resp.read1(1 << 16)
                    if not data:
                        break
                    handler.wfile.write(
                        hex(len(data))[2:].encode() + b"\r\n" + data
                        + b"\r\n")
                    handler.wfile.flush()
                handler.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass  # either side hung up
            finally:
                handler.close_connection = True
                conn.close()
            return
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        handler.wfile.write(payload)
        conn.close()

    # ---- lifecycle -------------------------------------------------------

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def store(self):
        return self.core.store

    def start(self) -> "AggregatedAPIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        # sever pooled keep-alive sockets (shutdown only stops the accept
        # loop; handler threads would keep mutating the store), and close
        # the never-started core server's bound listener too
        self._httpd.close_all_connections()
        self._httpd.server_close()
        self.core._httpd.close_all_connections()
        self.core._httpd.server_close()
        self.core.store.close()
