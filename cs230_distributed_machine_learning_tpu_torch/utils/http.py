"""A small JSON-over-HTTP client on ``urllib.request``.

The REST manager, the worker agent and the fetching dataset cache talk to
the coordinator through it; the JAX package uses ``requests``, which the
card's machine does not have. A reply of any status comes back as a
``Response``; a connection failure or a timeout raises ``ConnectionError``
/ ``TimeoutError`` (``TransportError`` covers both).
"""

from __future__ import annotations

import json as _json
import socket
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

#: the transport failures a caller may retry: nothing reached the server,
#: or its reply did not arrive in time
TransportError = (ConnectionError, TimeoutError)


class HTTPStatusError(Exception):
    """A reply with a 4xx / 5xx status (``Response.raise_for_status``)."""

    def __init__(self, response: "Response"):
        super().__init__(f"{response.status} for {response.url}: {response.text()[:200]}")
        self.response = response


class Response:
    def __init__(self, url: str, status: int, headers, body: bytes):
        self.url = url
        self.status = status
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return _json.loads(self.body.decode() or "null")

    def text(self) -> str:
        return self.body.decode(errors="replace")

    def raise_for_status(self) -> "Response":
        if self.status >= 400:
            raise HTTPStatusError(self)
        return self


def _url(url: str, params: Optional[Dict[str, Any]]) -> str:
    if not params:
        return url
    query = urllib.parse.urlencode({k: v for k, v in params.items() if v is not None})
    return f"{url}?{query}" if query else url


def open_request(method: str, url: str, *, json: Any = None,
                 params: Optional[Dict[str, Any]] = None,
                 headers: Optional[Dict[str, str]] = None, timeout: float = 30.0):
    """Send one request and return the open reply (an ``http.client``
    response, or the ``HTTPError`` that carries a 4xx / 5xx reply): for a
    streamed body the caller reads it and closes it."""
    data = None
    hdrs = dict(headers or {})
    if json is not None:
        data = _json.dumps(json).encode()
        hdrs.setdefault("Content-Type", "application/json")
    elif method.upper() == "POST":
        data = b""
    req = urllib.request.Request(_url(url, params), data=data, headers=hdrs,
                                 method=method.upper())
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e
    except urllib.error.URLError as e:
        if isinstance(e.reason, socket.timeout):
            raise TimeoutError(f"{method} {url}: {e.reason}") from e
        raise ConnectionError(f"{method} {url}: {e.reason}") from e
    except socket.timeout as e:
        raise TimeoutError(f"{method} {url}: timed out") from e
    except (ConnectionError, OSError) as e:
        raise ConnectionError(f"{method} {url}: {e}") from e


def request(method: str, url: str, *, json: Any = None,
            params: Optional[Dict[str, Any]] = None,
            headers: Optional[Dict[str, str]] = None, timeout: float = 30.0) -> Response:
    """One request, its whole body read."""
    resp = open_request(method, url, json=json, params=params, headers=headers,
                        timeout=timeout)
    try:
        status = resp.status if hasattr(resp, "status") else resp.code
        try:
            body = resp.read()
        except socket.timeout as e:
            raise TimeoutError(f"{method} {url}: reading the reply timed out") from e
        except (ConnectionError, OSError) as e:
            raise ConnectionError(f"{method} {url}: {e}") from e
        return Response(url, int(status), resp.headers, body)
    finally:
        resp.close()
