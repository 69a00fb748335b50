"""Runtime environments: shipping code + env vars to every worker.

Reference: ``python/ray/_private/runtime_env/`` — the agent materializes
per-job environments (working_dir/py_modules packaged through the GCS,
``packaging.py``; agent ``runtime_env_agent.py:159``).  Scope here: the
job-level environment — ``py_modules`` directories and ``env_vars`` packed
at ``ray_tpu_torch.init(runtime_env=...)`` into the GCS KV; every worker
materializes them once per job before executing that job's first task, so
multi-node deployments distribute real packages, not just cloudpickle
closures — plus the pip-venv, conda, and container isolation plugins
(workers pooled per env hash, launched under the env's interpreter or
inside ``podman run``).
"""

from __future__ import annotations

import io
import json
import os
import sys
import tarfile
from typing import Any, Dict, List, Optional

import cloudpickle

NS = "runtime_envs"


def _pack_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for root, _dirs, files in os.walk(path):
            for fn in files:
                if fn.endswith((".pyc", ".so.tmp")) or "__pycache__" in root:
                    continue
                full = os.path.join(root, fn)
                tf.add(full, arcname=os.path.relpath(full, path))
    return buf.getvalue()


def validate(runtime_env: Dict[str, Any]) -> Dict[str, Any]:
    known = {"py_modules", "env_vars", "working_dir", "pip", "pip_args",
             "container", "conda"}
    unknown = set(runtime_env) - known
    if unknown:
        raise ValueError(f"unsupported runtime_env keys: {sorted(unknown)} "
                         f"(supported: {sorted(known)})")
    pip = runtime_env.get("pip")
    if pip is not None and not (
            isinstance(pip, str)
            or (isinstance(pip, (list, tuple))
                and all(isinstance(p, str) for p in pip))):
        raise ValueError(
            "runtime_env['pip'] must be a list of requirement strings or a "
            f"requirements-file path, got {type(pip).__name__}")
    conda = runtime_env.get("conda")
    if conda is not None:
        if not (isinstance(conda, str)
                or (isinstance(conda, dict) and "dependencies" in conda)):
            raise ValueError(
                "runtime_env['conda'] must be an existing env name (str) "
                "or an environment spec dict with a 'dependencies' list "
                f"(reference conda.py), got {type(conda).__name__}")
        if "pip" in runtime_env:
            # reference: conda.py raises on conda+pip; pip deps belong in
            # the conda spec's dependencies themselves
            raise ValueError(
                "conda and pip runtime envs cannot be combined; put pip "
                "packages inside the conda spec's dependencies")
    container = runtime_env.get("container")
    if container is not None:
        if not isinstance(container, dict) or "image" not in container:
            raise ValueError(
                "runtime_env['container'] must be a dict with at least an "
                "'image' key, e.g. {'image': 'python:3.12', "
                "'run_options': ['--gpus=all']}")
        if container.get("run_options") is not None and not (
                isinstance(container["run_options"], (list, tuple))
                and all(isinstance(o, str)
                        for o in container["run_options"])):
            raise ValueError("container['run_options'] must be a list "
                             "of strings")
        ev = container.get("env_vars")
        if ev is not None and not (
                isinstance(ev, dict)
                and all(isinstance(k, str) and isinstance(v, str)
                        for k, v in ev.items())):
            raise ValueError("container['env_vars'] must be a dict of "
                             "str -> str")
        if "pip" in runtime_env:
            raise ValueError("container and pip runtime envs cannot be "
                             "combined: bake the packages into the image")
    return runtime_env


# ---------------------------------------------------------------------------
# pip/venv isolation (reference: _private/runtime_env/pip.py + uri_cache.py)
# ---------------------------------------------------------------------------

def pip_env_hash(runtime_env: Optional[Dict[str, Any]]) -> Optional[str]:
    """Cache key for a pip environment, or None when the env needs no
    dedicated interpreter.  Workers are pooled per hash: tasks with the same
    pip spec share venv workers; different specs never share a process."""
    if not runtime_env or not runtime_env.get("pip"):
        return None
    import hashlib
    pip = runtime_env["pip"]
    # string form = requirements-file path (Ray-compatible); list = reqs
    spec = (pip if isinstance(pip, str) else sorted(pip),
            list(runtime_env.get("pip_args") or []))
    return hashlib.sha1(repr(spec).encode()).hexdigest()[:16]


def conda_env_hash(runtime_env: Optional[Dict[str, Any]]) -> Optional[str]:
    """Cache/pool key for a conda environment (reference:
    conda.py get_conda_env_name — content hash of the spec)."""
    if not runtime_env or not runtime_env.get("conda"):
        return None
    import hashlib
    conda = runtime_env["conda"]
    spec = conda if isinstance(conda, str) else json.dumps(conda,
                                                           sort_keys=True)
    return hashlib.sha1(repr(spec).encode()).hexdigest()[:16]


def worker_env_hash(runtime_env: Optional[Dict[str, Any]]) -> Optional[str]:
    """Pool key for worker processes: tasks share an idle worker only when
    their isolation spec (pip venv / conda env AND/OR container) is
    identical."""
    parts = []
    h = pip_env_hash(runtime_env)
    if h:
        parts.append(f"pip:{h}")
    ch = conda_env_hash(runtime_env)
    if ch:
        parts.append(f"conda:{ch}")
    c = (runtime_env or {}).get("container")
    if c:
        import hashlib
        spec = (c["image"], list(c.get("run_options") or []),
                c.get("runtime") or "",
                sorted((c.get("env_vars") or {}).items()))
        parts.append(
            "ctr:" + hashlib.sha1(repr(spec).encode()).hexdigest()[:16])
    return "+".join(parts) or None


# ---------------------------------------------------------------------------
# container isolation (reference: _private/runtime_env/container.py —
# worker commands wrapped in `podman run`)
# ---------------------------------------------------------------------------

def container_runtime(container: Dict[str, Any]) -> str:
    """Resolve the container runtime binary, honoring an explicit
    ``container['runtime']``.  Raises with a clear message when no runtime
    exists on the node (CI boxes without podman/docker)."""
    import shutil
    explicit = container.get("runtime")
    candidates = [explicit] if explicit else ["podman", "docker"]
    for c in candidates:
        path = shutil.which(c)
        if path:
            return path
    raise RuntimeError(
        f"runtime_env['container'] requires a container runtime "
        f"({' or '.join(candidates)}) on the node, but none was found "
        f"on PATH")


def container_worker_argv(container: Dict[str, Any], session_dir: str,
                          pkg_root: str, env: Dict[str, str],
                          passthrough: Optional[set] = None,
                          name: Optional[str] = None,
                          worker_module: str = "ray_tpu_torch.core.worker_main"
                          ) -> list:
    """Build the argv that launches a worker inside the container.

    The container shares the host network (the worker dials the agent on
    127.0.0.1), the host IPC namespace + /dev/shm (the object store is a
    shm arena — without this, zero-copy reads cannot attach pool slices),
    the session dir (logs, spill, venv cache) and the framework source.
    Env passthrough is explicit (`run` starts from a clean environment by
    design): RAYTPU_*, the jax/TPU tuning vars, every key in
    ``passthrough`` (the agent passes its worker_env keys, so
    ``init(worker_env=...)`` behaves identically in and out of
    containers), plus container['env_vars'].  ``name`` makes the container
    addressable for teardown — killing the `run` CLIENT does not stop the
    container."""
    runtime = container_runtime(container)
    argv = [runtime, "run", "--rm", "--network=host", "--ipc=host",
            "-v", "/dev/shm:/dev/shm",
            "-v", f"{session_dir}:{session_dir}",
            "-v", f"{pkg_root}:{pkg_root}:ro"]
    if name:
        argv += ["--name", name]
    keep = set(passthrough or ())
    for k, v in env.items():
        if (k.startswith(("RAYTPU_", "JAX_", "XLA_", "TPU_", "LIBTPU_"))
                or k == "PYTHONPATH" or k in keep):
            argv += ["-e", f"{k}={v}"]
    for k, v in (container.get("env_vars") or {}).items():
        argv += ["-e", f"{k}={v}"]
    argv += list(container.get("run_options") or [])
    argv += [container["image"], "python", "-m", worker_module]
    return argv


_venv_locks: Dict[str, Any] = {}
_venv_guard = None


def materialize_pip_env(session_dir: str, runtime_env: Dict[str, Any]) -> str:
    """Build (or reuse) the venv for a pip runtime env; returns its python.

    Node-local URI cache: one venv per spec hash under
    ``{session_dir}/envs/{hash}`` with a ``.ready`` marker — concurrent
    requests for the same hash build once (per-hash lock).  The venv sees
    system site-packages (jax/numpy stay importable); pip installs overlay
    them (reference: pip.py creates the same system-site virtualenv).
    Runs in a worker thread — venv + pip take seconds."""
    import subprocess
    import sys
    import threading
    import venv as venv_mod

    global _venv_guard
    if _venv_guard is None:
        _venv_guard = threading.Lock()
    h = pip_env_hash(runtime_env)
    env_root = os.path.join(session_dir, "envs")
    env_dir = os.path.join(env_root, h)
    python = os.path.join(env_dir, "bin", "python")
    marker = os.path.join(env_dir, ".ready")
    with _venv_guard:
        lock = _venv_locks.setdefault(h, threading.Lock())
    os.makedirs(env_root, exist_ok=True)
    import fcntl
    lock_file = open(os.path.join(env_root, f".{h}.lock"), "w")
    try:
        with lock:
            # Cross-PROCESS exclusion too: every node agent of a local
            # cluster shares one session_dir, and venv.create(clear=True)
            # on a tree another agent is mid-install into destroys it.
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if os.path.exists(marker):
                return python
            venv_mod.create(env_dir, system_site_packages=True,
                            with_pip=False, clear=True)
            # The building interpreter may itself be a venv, whose packages
            # system_site_packages does NOT expose (it points at the BASE
            # prefix).  A .pth appends this process's site-packages so jax/
            # numpy/cloudpickle stay importable; the env's own site-packages
            # comes first on sys.path, so pip installs below shadow them.
            import glob
            import site
            sp = glob.glob(os.path.join(env_dir, "lib", "python*",
                                        "site-packages"))[0]
            with open(os.path.join(sp, "_parent_sites.pth"), "w") as f:
                f.write("\n".join(site.getsitepackages()))
            # Install with the PARENT's pip targeting the env interpreter —
            # avoids a slow ensurepip bootstrap per env.  A string pip spec
            # is a requirements-file path (reference API form).
            cmd = [sys.executable, "-m", "pip", "--python", python,
                   "install", "--quiet", "--disable-pip-version-check"]
            cmd += list(runtime_env.get("pip_args") or [])
            pip = runtime_env["pip"]
            cmd += ["-r", pip] if isinstance(pip, str) else list(pip)
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip install failed for runtime env {h}: "
                    f"{proc.stderr[-2000:]}")
            with open(marker, "w") as f:
                f.write("ok")
            return python
    finally:
        lock_file.close()  # releases the flock


# ---------------------------------------------------------------------------
# conda isolation (reference: _private/runtime_env/conda.py — named envs
# activate, dict specs create content-hashed envs under the session dir)
# ---------------------------------------------------------------------------

def find_conda_exe() -> str:
    """Resolve the conda binary: RAYTPU_CONDA_EXE (the test seam and the
    operator override) beats PATH lookup of conda/mamba/micromamba."""
    import shutil
    explicit = os.environ.get("RAYTPU_CONDA_EXE")
    candidates = [explicit] if explicit else ["conda", "mamba", "micromamba"]
    for c in candidates:
        path = shutil.which(c)
        if path:
            return path
    raise RuntimeError(
        "runtime_env['conda'] requires a conda binary "
        f"({' or '.join(candidates)}) on the node, but none was found on "
        "PATH (set RAYTPU_CONDA_EXE to point at one)")


def materialize_conda_env(session_dir: str,
                          runtime_env: Dict[str, Any]) -> str:
    """Return the python interpreter of the env's conda environment.

    * name form (``conda="myenv"``): resolve the EXISTING env's python via
      ``conda run -n myenv python -c 'print(sys.executable)'`` — no
      mutation, matching the reference's activate-by-name path.
    * spec form (dict): ``conda env create -p {session}/conda/{hash}`` from
      the spec written as JSON (a YAML subset conda accepts), cached by
      content hash with a ``.ready`` marker + flock, exactly like the pip
      venv cache above.
    """
    import fcntl
    import subprocess

    conda_exe = find_conda_exe()
    conda = runtime_env["conda"]
    if isinstance(conda, str):
        proc = subprocess.run(
            [conda_exe, "run", "-n", conda, "python", "-c",
             "import sys; print(sys.executable)"],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0 or not proc.stdout.strip():
            raise RuntimeError(
                f"conda env {conda!r} is not usable via {conda_exe}: "
                f"{proc.stderr[-2000:]}")
        return proc.stdout.strip().splitlines()[-1]

    h = conda_env_hash(runtime_env)
    env_root = os.path.join(session_dir, "conda")
    env_dir = os.path.join(env_root, h)
    python = os.path.join(env_dir, "bin", "python")
    marker = os.path.join(env_dir, ".ready")
    os.makedirs(env_root, exist_ok=True)
    lock_file = open(os.path.join(env_root, f".{h}.lock"), "w")
    try:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(marker):
            return python
        if os.path.isdir(env_dir):
            # a previous create died mid-install (no marker): conda
            # refuses to create into a non-empty prefix, so self-heal by
            # clearing it — the pip path's venv.create(clear=True)
            # equivalent
            import shutil
            shutil.rmtree(env_dir, ignore_errors=True)
        spec_path = os.path.join(env_root, f"{h}.yml")
        with open(spec_path, "w") as f:
            json.dump(conda, f)  # JSON is valid YAML: conda reads it
        proc = subprocess.run(
            [conda_exe, "env", "create", "-y", "-p", env_dir,
             "-f", spec_path],
            capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0 or not os.path.exists(python):
            raise RuntimeError(
                f"conda env create failed for runtime env {h}: "
                f"{proc.stderr[-2000:]}")
        with open(marker, "w") as f:
            f.write("ok")
        return python
    finally:
        lock_file.close()  # releases the flock


def publish(gcs_call, job_id_hex: str, runtime_env: Dict[str, Any]):
    """Driver side: pack + store the env under the job id (reference:
    packaging.upload_package_if_needed)."""
    validate(runtime_env)
    blob: Dict[str, Any] = {"env_vars": dict(runtime_env.get("env_vars")
                                             or {})}
    mods = []
    for path in runtime_env.get("py_modules") or []:
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise ValueError(f"py_modules entry is not a directory: {path}")
        mods.append((os.path.basename(path), _pack_dir(path)))
    blob["py_modules"] = mods
    if runtime_env.get("working_dir"):
        blob["working_dir"] = _pack_dir(runtime_env["working_dir"])
    gcs_call("kv_put", ns=NS, key=job_id_hex, value=cloudpickle.dumps(blob))


_materialized: set = set()
#: per-job process-level mutations (env_vars, cwd) for re-application when a
#: shared worker interleaves tasks of different jobs
_applied_state: dict = {}
_last_applied: Optional[str] = None


def ensure(worker, job_id_hex: str):
    """Worker side: materialize the job's env once (idempotent, cheap on the
    hot path — one KV miss per job when no env exists).  The job is marked
    materialized only AFTER success, so a transient GCS/extract failure
    retries on the next task instead of silently disabling the env.

    Workers are shared across jobs, so the process-wide pieces (env vars,
    cwd) RE-apply whenever the executing job changes — sys.path additions
    accumulate (harmless: packages are namespaced per job dir)."""
    global _last_applied
    if job_id_hex in _materialized:
        if _last_applied != job_id_hex:
            _reapply(job_id_hex)
        return
    from .rpc import run_async

    raw = run_async(worker.gcs.call_retry("kv_get", ns=NS, key=job_id_hex,
                                          _idempotent=False))
    if raw is None:
        _materialized.add(job_id_hex)
        _applied_state[job_id_hex] = None
        if _last_applied != job_id_hex:
            _last_applied = job_id_hex
        return
    blob = cloudpickle.loads(raw)
    base = os.path.join(worker.session_dir, "runtime_envs", job_id_hex)
    for name, data in blob.get("py_modules", []):
        dest = os.path.join(base, "py_modules", name)
        if not os.path.isdir(dest):
            os.makedirs(dest, exist_ok=True)
            with tarfile.open(fileobj=io.BytesIO(data)) as tf:
                tf.extractall(dest, filter="data")
        parent = os.path.dirname(dest)
        if parent not in sys.path:
            sys.path.insert(0, parent)
    if blob.get("working_dir"):
        dest = os.path.join(base, "working_dir")
        if not os.path.isdir(dest):
            os.makedirs(dest, exist_ok=True)
            with tarfile.open(fileobj=io.BytesIO(
                    blob["working_dir"])) as tf:
                tf.extractall(dest, filter="data")
        if dest not in sys.path:
            sys.path.insert(0, dest)
        os.chdir(dest)
    for k, v in blob.get("env_vars", {}).items():
        os.environ[k] = str(v)
    _applied_state[job_id_hex] = {
        "env_vars": dict(blob.get("env_vars", {})),
        "cwd": (os.path.join(base, "working_dir")
                if blob.get("working_dir") else None),
    }
    _materialized.add(job_id_hex)
    _last_applied = job_id_hex


def _reapply(job_id_hex: str):
    global _last_applied
    state = _applied_state.get(job_id_hex)
    _last_applied = job_id_hex
    if not state:
        return
    for k, v in state["env_vars"].items():
        os.environ[k] = str(v)
    if state["cwd"] and os.path.isdir(state["cwd"]):
        os.chdir(state["cwd"])
