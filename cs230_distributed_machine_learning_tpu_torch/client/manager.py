"""MLTaskManager: the user-facing client API.

Port of the JAX package's ``client/manager.py``. In local mode (no
``url``) the manager talks directly to an in-process Coordinator; with
``url=`` it talks REST to a coordinator server (runtime/server.py), with
the JAX manager's retries and backoff for idempotent requests, the SSE
stream of ``/train_status`` for ``stream=True``, and the winner's artifact
fetched from ``/download_model``. ``download_data``,
``check_data`` and ``preprocess`` stage a dataset; ``train`` accepts a
live sklearn estimator, a GridSearchCV / RandomizedSearchCV wrapper, or the
``model_details`` payload they stand for (client/introspection.py; the
form to use where scikit-learn is not installed), plus ``train_params``,
and optionally blocks until the job ends, following the job's event
stream with ``stream=True``; ``search_params`` makes it an adaptive
search (ASHA / Hyperband); ``check_status`` / ``check_job_status`` /
``best_result`` / ``curves`` read results and learning curves;
``download_best_model`` / ``load_best_model`` refit the winner once and
serve its artifact (runtime/artifacts.py); ``explain`` reads one subtask's
flight-recorder timeline and ``critical_path`` a job's wall decomposition.

Each ``train`` mints a trace id (``trace_id``): in local mode it is
activated around a ``client.train`` span, over REST it rides the
``X-Trace-Id`` header of the submit and the stream, so the job's spans
(``GET /trace/<job_id>``) start at the client.

The constructor takes the JAX package's ``(url, coordinator, priority)``.
A local-mode coordinator runs on the CUDA card by default; ``device="cpu"``
runs it on the host, and without a card and without ``device="cpu"``
construction raises. Over REST the server's workers decide the device.
The REST transport is written on ``urllib.request`` (utils/http.py). It
refuses what cannot cross it: a callable ``scoring``, and a scipy
distribution in a search space (JSON turns it into a string), each with a
``ValueError`` at the client that names it.
"""

from __future__ import annotations

import json
import random
import time
import uuid
from typing import Any, Dict, Optional

from ..obs import TRACE_HEADER, activate, new_trace_id, span
from ..runtime.store import TERMINAL_STATUSES
from ..utils import http
from ..utils.config import get_config
from ..utils.serialization import json_safe
from ..utils.torch_setup import DeviceLike
from .introspection import extract_model_details


class MLTaskManager:
    def __init__(self, url: Optional[str] = None, coordinator=None, priority: int = 0, *,
                 device: DeviceLike = None):
        """``priority`` is this session's QoS lane (its subtasks dispatch
        ahead of lower lanes on a backlogged cluster), journaled with the
        session as in the JAX package."""
        self.api_url = url.rstrip("/") if url else None
        self.priority = int(priority)
        if self.api_url is None:
            if coordinator is None:
                from ..runtime.coordinator import Coordinator

                coordinator = Coordinator(device=device)
            self._coordinator = coordinator
        else:
            self._coordinator = None
        self.session_id = self._create_session()
        self.job_id: Optional[str] = None
        self.result: Optional[Dict[str, Any]] = None
        #: the trace id of the latest train(), minted here and sent to the
        #: coordinator (GET /trace/<job_id> reads the job's spans)
        self.trace_id: Optional[str] = None

    @property
    def device(self):
        """The local coordinator's device; None over REST."""
        return self._coordinator.device if self._coordinator is not None else None

    def _create_session(self) -> str:
        if self._coordinator is not None:
            return self._coordinator.create_session(priority=self.priority)
        return self._request("post", "create_session",
                             json={"priority": self.priority} if self.priority else None,
                             idempotent=False)["session_id"]

    # ------------- data management -------------

    def check_data(self, data_name: str) -> Dict[str, Any]:
        if self._coordinator is not None:
            return self._coordinator.check_data(self.session_id, data_name)
        return self._request("get", f"check_data/{self.session_id}",
                             params={"dataset_name": data_name})

    def download_data(self, data_link: str, data_name: str, data_type: str) -> Dict[str, Any]:
        if self._coordinator is not None:
            return self._coordinator.download_data(self.session_id, data_link, data_name,
                                                   data_type)
        return self._request("post", f"download_data/{self.session_id}",
                             json={"dataset_url": data_link, "dataset_name": data_name,
                                   "dataset_type": data_type})

    def preprocess(self, dataset_id: str,
                   config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Preprocess a staged dataset with a config dict, or with the
        YAML under the configs directory when ``config`` is None."""
        if self._coordinator is not None:
            return self._coordinator.preprocess(self.session_id, dataset_id, config)
        return self._request("post", f"preprocess/{self.session_id}",
                             json={"dataset_id": dataset_id, "config": config})

    def train(
        self,
        estimator: Any,
        dataset_id: Optional[str] = None,
        train_params: Optional[Dict[str, Any]] = None,
        wait_for_completion: bool = True,
        timeout: Optional[float] = None,
        show_progress: bool = True,
        *,
        dataset_name: Optional[str] = None,
        stream: bool = False,
        search_params: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Submit a training / hyperparameter-search job.

        The signature is the JAX package's, in its order.
        estimator: a sklearn estimator or search wrapper, or a
        ``model_details`` dict ({model_type, search_type,
        base_estimator_params, param_grid | param_distributions + n_iter +
        random_state, cv_params}).
        train_params: {test_size=0.2, random_state=42, cv=5}.
        ``show_progress`` draws a progress bar (tqdm, where installed)
        while ``stream=True`` follows the job; the blocking wait draws none
        (the JAX package's local wait with it off).
        ``dataset_name=`` is accepted as an alias for ``dataset_id``.

        ``search_params=`` makes the job an adaptive search (docs/SEARCH.md):
        ``{"type": "asha" | "hyperband", "eta": 3, "min_resource": r,
        "max_resource": R, "n_iter": n, "stop_score": s, "max_brackets":
        b}``. The estimator's grid or distributions supply the trial
        configurations; the rung controller owns the resource parameter
        (max_iter / n_estimators) and stops doomed trials early as
        ``pruned``.

        ``stream=True`` (with ``wait_for_completion``) follows the job by
        consuming the coordinator's ``stream_status`` generator; the last
        event carries ``job_result``.
        """
        if dataset_name is not None:
            if dataset_id is not None and dataset_id != dataset_name:
                raise TypeError(
                    f"conflicting dataset_id={dataset_id!r} and "
                    f"dataset_name={dataset_name!r} — pass one"
                )
            dataset_id = dataset_name
        if dataset_id is None:
            raise TypeError("train() requires a dataset id (dataset_id= or dataset_name=)")
        model_details = extract_model_details(estimator)
        if search_params:
            sp = dict(search_params)
            stype = sp.pop("type", "asha")
            if stype not in ("asha", "hyperband"):
                raise ValueError(
                    f"search_params['type'] must be 'asha' or 'hyperband', got {stype!r}")
            model_details["search_type"] = stype
            for key in ("n_iter", "random_state"):
                if key in sp:
                    model_details[key] = sp.pop(key)
            model_details["asha"] = sp
        train_params = dict(train_params or {})
        train_params.setdefault("test_size", get_config().execution.default_test_size)
        self.job_id = str(uuid.uuid4())
        payload = {
            "job_id": self.job_id,
            "session_id": self.session_id,
            "dataset_id": dataset_id,
            "model_details": model_details,
            "train_params": train_params,
            "timestamp": time.time(),
        }
        self.trace_id = new_trace_id()
        if self._coordinator is not None:
            # the job's trace starts here: submit_train (this process)
            # adopts the active id, under the client's span
            with activate(self.trace_id):
                with span("client.train", trace_id=self.trace_id, job_id=self.job_id,
                          dataset_id=dataset_id):
                    submit = self._coordinator.submit_train(self.session_id, payload)
        else:
            _check_rest_payload(model_details)
            if stream and wait_for_completion:
                # /train_status submits and streams: one request
                return self._train_stream(payload, timeout=timeout,
                                          show_progress=show_progress)
            # idempotent: the coordinator dedupes the client-minted job id,
            # so a retried POST never expands the job twice
            submit = self._request("post", f"train/{self.session_id}", json=payload,
                                   idempotent=True, headers={TRACE_HEADER: self.trace_id})
        self.job_id = submit.get("job_id") or self.job_id
        if not wait_for_completion:
            return submit
        if stream:
            return self._stream_local(timeout=timeout, show_progress=show_progress)
        if self._coordinator is None:
            return self._wait_remote(timeout=timeout, show_progress=show_progress)
        self._coordinator.wait_for_completion(self.session_id, self.job_id, timeout)
        status = self.check_status()
        if status.get("job_status") in TERMINAL_STATUSES:
            self.result = status.get("job_result")
        return status

    def _wait_remote(self, timeout: Optional[float] = None,
                     show_progress: bool = True) -> Dict[str, Any]:
        """Poll ``/check_status`` every ``client_poll_s`` to the job's end."""
        cfg = get_config().service
        timeout = timeout or cfg.client_timeout_s
        deadline = time.time() + timeout
        bar = self._progress_bar(show_progress)
        try:
            while time.time() < deadline:
                status = self.check_status()
                if bar is not None:
                    bar.n = int(_pct(status.get("job_status")))
                    _bar_postfix(bar, status)
                    bar.refresh()
                if status.get("job_status") in TERMINAL_STATUSES:
                    self.result = status.get("job_result")
                    return status
                time.sleep(cfg.client_poll_s)
        finally:
            if bar is not None:
                bar.close()
        raise TimeoutError(f"Job {self.job_id} did not complete within {timeout}s")

    # ------------- the event stream (stream=True) -------------

    @staticmethod
    def _progress_bar(show_progress: bool):
        if not show_progress:
            return None
        try:
            from tqdm import tqdm

            # disable=None: off when stderr is not a tty
            return tqdm(total=100, desc="job", unit="%", disable=None)
        except ImportError:
            return None

    def _finish_stream(self, last: Optional[Dict[str, Any]], timeout: float):
        if last is None or last.get("job_status") not in TERMINAL_STATUSES:
            raise TimeoutError(
                f"Job {self.job_id} stream ended without completion (timeout {timeout}s)")
        self.result = last.get("job_result")
        return last

    def _stream_local(self, timeout: Optional[float] = None,
                      show_progress: bool = True) -> Dict[str, Any]:
        """Iterate the coordinator's ``stream_status`` generator to the
        job's end; curve events are skipped (``curves()`` reads them)."""
        timeout = timeout or get_config().service.client_timeout_s
        deadline = time.time() + timeout
        bar = self._progress_bar(show_progress)
        last: Optional[Dict[str, Any]] = None
        try:
            for progress in self._coordinator.stream_status(self.session_id, self.job_id):
                if progress.get("kind") == "curve":
                    continue
                last = progress
                if bar is not None:
                    bar.n = int(_pct(progress.get("job_status")))
                    _bar_postfix(bar, progress)
                    bar.refresh()
                if progress.get("job_status") in TERMINAL_STATUSES:
                    break
                if time.time() > deadline:
                    raise TimeoutError(f"Job {self.job_id} did not complete within {timeout}s")
        finally:
            if bar is not None:
                bar.close()
        return self._finish_stream(last, timeout)

    def _train_stream(self, payload: Dict[str, Any], timeout: Optional[float] = None,
                      show_progress: bool = True) -> Dict[str, Any]:
        """POST the job to ``/train_status`` and read its SSE events (one
        request submits and follows). A dropped stream is resumed, not
        raised: the payload's client-minted job id makes the re-POST
        re-attach to the same job, and each event is a whole progress
        snapshot. 429 / 503 back off per their ``Retry-After``; an endpoint
        that never answered raises after ``request_retry_s``."""
        cfg = get_config().service
        timeout = timeout or cfg.client_timeout_s
        start = time.time()
        deadline = start + timeout
        retry_window = max(cfg.request_retry_s, 0.0)
        read_timeout = max(10.0, 8 * cfg.sse_tick_s)
        bar = self._progress_bar(show_progress)
        last: Optional[Dict[str, Any]] = None
        attempt = 0
        established = False  # a stream was opened at least once
        try:
            while time.time() < deadline:
                try:
                    resp = http.open_request(
                        "POST", f"{self.api_url}/train_status/{self.session_id}",
                        json=json_safe(payload), timeout=read_timeout,
                        headers={TRACE_HEADER: self.trace_id} if self.trace_id else None)
                except http.TransportError:
                    if not established and time.time() - start > retry_window:
                        raise
                    attempt += 1
                    time.sleep(_retry_delay(attempt))
                    continue
                status = getattr(resp, "status", None) or resp.code
                if status in (429, 503) and retry_window > 0:
                    retry_after = resp.headers.get("Retry-After")
                    resp.close()
                    attempt += 1
                    time.sleep(_retry_delay(attempt, retry_after))
                    continue
                if status >= 400:
                    body = resp.read()
                    resp.close()
                    raise http.HTTPStatusError(http.Response(
                        f"{self.api_url}/train_status/{self.session_id}", status,
                        resp.headers, body))
                established = True
                try:
                    for raw in resp:
                        line = raw.decode().rstrip("\r\n")
                        if not line.startswith("data: "):
                            continue
                        try:
                            event = json.loads(line[len("data: "):])
                        except ValueError:
                            continue  # a torn event: the stream is ending
                        attempt = 0
                        if event.get("kind") == "curve":
                            continue  # curves() reads them
                        last = event
                        if event.get("job_id"):
                            self.job_id = event["job_id"]
                        if bar is not None:
                            bar.n = int(_pct(event.get("job_status")))
                            _bar_postfix(bar, event)
                            bar.refresh()
                        if event.get("job_status") in TERMINAL_STATUSES:
                            return self._finish_stream(last, timeout)
                        if time.time() > deadline:
                            raise TimeoutError(
                                f"Job {self.job_id} did not complete within {timeout}s")
                except (OSError, ValueError):
                    # the stream dropped mid-job: resume by re-POSTing
                    attempt += 1
                    time.sleep(_retry_delay(attempt))
                finally:
                    resp.close()
                # a stream that ended without a terminal event resumes too,
                # paced at the tick
                time.sleep(min(1.0, max(cfg.sse_tick_s, 0.1)))
            return self._finish_stream(last, timeout)
        finally:
            if bar is not None:
                bar.close()

    def check_status(self, job_id: Optional[str] = None) -> Dict[str, Any]:
        jid = job_id or self.job_id
        if self._coordinator is not None:
            return self._coordinator.check_status(self.session_id, jid)
        return self._request("get", f"check_status/{self.session_id}/{jid}")

    def check_job_status(self, job_id: Optional[str] = None):
        """Per-trial metrics array."""
        jid = job_id or self.job_id
        if self._coordinator is not None:
            return self._coordinator.job_metrics(self.session_id, jid)
        return self._request("get", f"metrics/{self.session_id}/{jid}")

    def explain(self, job_id: Optional[str] = None,
                subtask_id: Optional[str] = None) -> Dict[str, Any]:
        """The flight recorder's timeline of one subtask of a job, every
        scheduling decision in order (placement with its score breakdown,
        lease grant and reclaim, attempts and retries, speculation, the
        terminal result). ``job_id`` defaults to the latest ``train()``;
        KeyError when the coordinator recorded nothing for the pair
        (unknown ids, or a run under ``CS230_OBS=0``)."""
        jid = job_id or self.job_id
        if jid is None or subtask_id is None:
            raise TypeError("explain() requires a job id (or a prior train()) and a subtask_id")
        if self._coordinator is not None:
            return self._coordinator.explain(jid, subtask_id)
        try:
            return self._request("get", f"explain/{jid}/{subtask_id}")
        except http.HTTPStatusError as e:
            if e.response.status == 404:
                raise KeyError(
                    f"no recorded events for subtask {subtask_id!r} of job {jid!r}") from e
            raise

    def critical_path(self, job_id: Optional[str] = None,
                      compare: Optional[str] = None) -> Dict[str, Any]:
        """A job's wall decomposed into critical-path segments that tile it
        (gaps labeled ``untraced``), the dominant segment, and the retry and
        speculation attribution. ``compare=<baseline_job_id>`` adds a
        per-segment diff against that job (``report["diff"]``). ``job_id``
        defaults to the latest ``train()``; KeyError when no trace is bound
        to the job (unknown id, or ``CS230_OBS=0``)."""
        jid = job_id or self.job_id
        if jid is None:
            raise TypeError("critical_path() requires a job id (or a prior train())")
        if self._coordinator is not None:
            report = self._coordinator.critical_path(jid)
            if report is None:
                raise KeyError(f"no critical path for job {jid!r}")
            if compare is not None:
                from ..obs.critpath import compare as _compare

                base = self._coordinator.critical_path(compare)
                if base is None:
                    raise KeyError(f"no critical path for job {compare!r}")
                report["diff"] = _compare(base, report)
            return report
        try:
            return self._request("get", f"critical_path/{jid}",
                                 params={"compare": compare} if compare is not None else None)
        except http.HTTPStatusError as e:
            if e.response.status == 404:
                raise KeyError(f"no critical path for job {jid!r}") from e
            raise

    def curves(self, job_id: Optional[str] = None,
               subtask_id: Optional[str] = None) -> Dict[str, Any]:
        """Learning curves captured in the fits of a job, or of one trial
        with ``subtask_id``. Each entry carries the per-split trace (loss,
        score or grad-norm channels), its rung and attempt, and the
        watchdog's ``diverged`` flag. ``job_id`` defaults to the latest
        ``train()``; KeyError for an unknown job, or a trial with no curve."""
        jid = job_id or self.job_id
        if jid is None:
            raise TypeError("curves() requires a job id (or a prior train())")
        if self._coordinator is None:
            path = f"curves/{jid}" if subtask_id is None else f"curves/{jid}/{subtask_id}"
            try:
                return self._request("get", path)
            except http.HTTPStatusError as e:
                if e.response.status == 404:
                    raise KeyError(f"no curves for job {jid!r}"
                                   + (f" subtask {subtask_id!r}" if subtask_id else "")) from e
                raise
        if subtask_id is not None:
            return self._coordinator.subtask_curves(jid, subtask_id)
        out = self._coordinator.job_curves(jid)
        if out is None:
            raise KeyError(f"no job {jid!r}")
        return out

    def best_result(self, job_id: Optional[str] = None) -> Optional[Dict[str, Any]]:
        result = self.check_status(job_id).get("job_result") or {}
        return result.get("best_result")

    def download_best_model(self, job_id: Optional[str] = None,
                            output_path: Optional[str] = None) -> str:
        """Path of the job's winner artifact (``<subtask_id>_model.pkl``
        under the models directory), refitted on the first call; copied to
        ``output_path`` when given, and that path returned."""
        jid = job_id or self.job_id
        if self._coordinator is None:
            # the server refits on its first download, so this waits for
            # the refit (the JAX manager's 60 s would cut a long one)
            out = output_path or f"{jid}_best_model.pkl"
            resp = http.request("GET", f"{self.api_url}/download_model/{self.session_id}/{jid}",
                                timeout=get_config().service.client_timeout_s)
            if resp.status == 404:
                raise FileNotFoundError("No best model artifact for this job")
            resp.raise_for_status()
            with open(out, "wb") as f:
                f.write(resp.body)
            return out
        path = self._coordinator.best_model_path(self.session_id, jid)
        if path is None:
            raise FileNotFoundError("No best model artifact for this job")
        if output_path:
            import shutil

            shutil.copy(path, output_path)
            return output_path
        return path

    def load_best_model(self, job_id: Optional[str] = None, as_sklearn: bool = True):
        """Download the winning artifact and load it: by default as a fitted
        scikit-learn estimator (runtime/sklearn_export.py; raises
        ``ScikitLearnMissing`` where scikit-learn is not installed), with
        ``as_sklearn=False`` as the artifact dict, which
        ``runtime.artifacts.predict_with_artifact`` predicts with."""
        from ..runtime.artifacts import load_artifact, to_sklearn

        artifact = load_artifact(self.download_best_model(job_id))
        return to_sklearn(artifact) if as_sklearn else artifact


    # ------------- REST plumbing -------------

    def _request(self, method: str, endpoint: str, json=None, params=None,
                 idempotent: Optional[bool] = None,
                 headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        """One REST call with the JAX manager's resilience: 429 / 503 are
        retried after their ``Retry-After`` (the request was not processed,
        so any method may retry), and transport errors are retried with
        capped jittered backoff for idempotent requests (GETs by default;
        train submits opt in, the coordinator dedupes their job id), for
        ``service.request_retry_s`` (0 disables)."""
        url = f"{self.api_url}/{endpoint.lstrip('/')}"
        if idempotent is None:
            idempotent = method.lower() == "get"
        deadline = time.time() + max(get_config().service.request_retry_s, 0.0)
        attempt = 0
        while True:
            try:
                resp = http.request(method, url,
                                    json=json_safe(json) if json is not None else None,
                                    params=params, headers=headers, timeout=600)
            except http.TransportError:
                if not idempotent or time.time() >= deadline:
                    raise
                attempt += 1
                time.sleep(_retry_delay(attempt))
                continue
            if resp.status in (429, 503) and time.time() < deadline:
                attempt += 1
                time.sleep(_retry_delay(attempt, resp.headers.get("Retry-After")))
                continue
            return resp.raise_for_status().json()


def _check_rest_payload(model_details: Dict[str, Any]) -> None:
    """Refuse, at the client, what JSON cannot carry to the server: a
    callable ``scoring`` (it would turn into an unknown scorer's name) and
    a scipy distribution in ``param_distributions`` / ``param_grid`` (it
    would turn into its ``str()``, which the server cannot sample)."""
    scoring = (model_details.get("cv_params") or {}).get("scoring")
    if callable(scoring) and not isinstance(scoring, str):
        raise ValueError(
            "callable scoring cannot be sent over the REST transport (it is not "
            "JSON-serializable); use a scorer name, or a local-mode MLTaskManager for "
            "callable scorers")
    for key in ("param_distributions", "param_grid"):
        space = model_details.get(key)
        for grid in (space if isinstance(space, list) else [space]):
            for name, values in (grid or {}).items():
                if hasattr(values, "rvs"):
                    raise ValueError(
                        f"{key}[{name!r}] is a distribution ({values!r}), which cannot be "
                        "sent over the REST transport; send a list of values (a "
                        "GridSearchCV grid of the draws), or use a local-mode MLTaskManager")


def _retry_delay(attempt: int, retry_after=None, cap: float = 30.0) -> float:
    """Capped jittered backoff: a server's ``Retry-After`` is the floor,
    padded with up to 25 % jitter; otherwise exponential from 0.5 s with
    full jitter."""
    if retry_after is not None:
        try:
            return min(float(retry_after) * (1.0 + 0.25 * random.random()), cap)
        except (TypeError, ValueError):
            pass
    return min(10.0, 0.5 * 2 ** min(attempt - 1, 5)) * (0.5 + random.random())


def _bar_postfix(bar, progress: Dict[str, Any]) -> None:
    """Adaptive-search decoration of the progress bar: the pruned and
    diverged counts and the highest rung with a report."""
    pruned = progress.get("tasks_pruned")
    diverged = progress.get("tasks_diverged")
    search = progress.get("search")
    if not pruned and not diverged and not search:
        return
    post = {}
    if pruned:
        post["pruned"] = pruned
    if diverged:
        post["diverged"] = diverged
    if isinstance(search, dict):
        rungs = [r for b in (search.get("brackets") or [search])
                 for r in (b.get("rungs") or []) if r.get("reported")]
        if rungs:
            post["rung"] = max(r["rung"] for r in rungs)
    try:
        bar.set_postfix(post, refresh=False)
    except Exception:  # noqa: BLE001 — cosmetic only
        pass


def _pct(job_status) -> float:
    if job_status in ("completed", "completed_with_failures"):
        return 100.0
    if isinstance(job_status, str) and job_status.endswith("%"):
        try:
            return float(job_status[:-1])
        except ValueError:
            return 0.0
    return 0.0
