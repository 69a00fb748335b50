"""External-env protocol: train on simulators that live outside the process.

Counterpart of ``ray_tpu/rllib/external.py`` (reference surface:
``rllib/env/policy_client.py``, the remote-inference commands
START_EPISODE / GET_ACTION / LOG_ACTION / LOG_RETURNS / END_EPISODE, and
``rllib/env/policy_server_input.py``, a threaded HTTP server that doubles
as the algorithm's sample-input reader).  The server holds the model and
its current params on the server's device (``device=None``: the card);
each inference is one forward over a [1, ...] batch there, and the action
is drawn on the host from numpy's ``default_rng(0)`` under a lock, as the
reference draws it.  The sample stream is assembled in the learner's
``[T, 1, ...]`` rollout layout, episode boundaries riding the ``dones``
channel.  ``set_weights`` swaps in a new dict of tensors under the lock;
it never writes into tensors a handler thread may be reading.

The wire is the reference's: pickled dicts over HTTP POST, so either
package's ``PolicyClient`` drives either package's server.  Unpickling
runs code: serve a trusted network only (the reference's assumption
too), and never expose the port publicly.

Usage (driver side)::

    config = (PPOConfig().environment(observation_space=...,
                                      action_space=...).external(port=9900))
    algo = config.build()       # serves the policy at 127.0.0.1:9900
    algo.train()                # consumes externally collected samples

External simulator::

    client = PolicyClient("127.0.0.1:9900")
    eid = client.start_episode()
    action = client.get_action(eid, obs)
    client.log_returns(eid, reward)
    client.end_episode(eid, obs)
"""

from __future__ import annotations

import http.server
import pickle
import socketserver
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .learner import to_numpy

__all__ = ["PolicyServerInput", "PolicyClient"]


class _Episode:
    def __init__(self, training_enabled: bool = True):
        self.training_enabled = training_enabled
        #: committed within-episode steps: (obs, action, logp, value, reward)
        self.steps: List[tuple] = []
        #: the last acted step, waiting for its reward: (obs, a, logp, v)
        self.pending: Optional[tuple] = None
        self.pending_reward = 0.0
        self.total_reward = 0.0
        self.started = time.monotonic()  # refreshed on activity (TTL sweep)


class PolicyServerInput:
    """Serve the current policy over HTTP and collect the resulting
    experience as training input (reference: ``policy_server_input.py:28``,
    HTTPServer and InputReader in one).

    ``params``: a dict of numpy arrays (``get_weights()``) or tensors.
    ``next(min_steps)`` blocks until that many committed steps exist and
    returns one rollout dict in the learner's ``[T, 1, ...]`` layout.
    """

    def __init__(self, model, params, address: str = "127.0.0.1",
                 port: int = 9900, gamma: float = 0.99,
                 fragment_len: int = 64, episode_ttl_s: float = 3600.0,
                 device=None):
        self.model = model
        self.device = device_mod.resolve(device)
        self.gamma = float(gamma)
        self.fragment_len = int(fragment_len)
        self.episode_ttl_s = float(episode_ttl_s)
        self._lock = threading.Lock()
        self._params = self._own(params)
        self._params_version = 0
        self._episodes: Dict[str, _Episode] = {}
        # committed stream: (obs, action, logp, value, reward, done), whole
        # contiguous per-episode fragments only, each ending done=1
        # (truncated fragments fold gamma*V(next_obs) into the last reward,
        # the time-limit bootstrap), so GAE never bootstraps across
        # interleaved episodes
        self._steps: List[tuple] = []
        self._returns: List[float] = []
        self._steps_ready = threading.Condition(self._lock)
        # numpy Generators are not thread-safe; handler threads sample
        # concurrently, so sampling holds its own small lock
        self._rng = np.random.default_rng(0)
        self._rng_lock = threading.Lock()

        handler = self._make_handler()

        class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True

        self._server = _Server((address, port), handler)
        self.address = f"{address}:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="policy-server")
        self._thread.start()

    def _own(self, params) -> Dict[str, torch.Tensor]:
        """A new dict of tensors on the server's device that no caller
        holds."""
        return {k: (v.detach().to(self.device, copy=True)
                    if isinstance(v, torch.Tensor)
                    else torch.tensor(np.asarray(v), device=self.device))
                for k, v in params.items()}

    # ------------------------------------------------------------ commands

    def _cmd_start_episode(self, req):
        eid = req.get("episode_id") or uuid.uuid4().hex[:12]
        with self._lock:
            # opportunistic TTL sweep: a crashed external client never ends
            # its episodes, so stale ones would leak forever
            cutoff = time.monotonic() - self.episode_ttl_s
            for k in [k for k, e in self._episodes.items()
                      if e.started < cutoff]:
                del self._episodes[k]
            self._episodes[eid] = _Episode(req.get("training_enabled", True))
        return {"episode_id": eid}

    @torch.no_grad()
    def _policy_step(self, obs: np.ndarray):
        """One inference: (action, logp, value) for a single observation,
        the forward on the server's device, the draw on the host."""
        params = self._params   # one read: set_weights swaps the dict
        pi_out, value = self.model.apply(
            params, torch.as_tensor(obs[None], dtype=torch.float32).to(
                self.device))
        kind, a, b = self.model.dist(pi_out)
        value = float(value[0])
        if kind == "gaussian":
            mean = a[0].cpu().numpy()
            log_std = b[0].cpu().numpy()
            std = np.exp(log_std)
            with self._rng_lock:
                noise = self._rng.standard_normal(mean.shape)
            action = mean + std * noise
            logp = float(np.sum(
                -0.5 * ((action - mean) / std) ** 2 - log_std
                - 0.5 * np.log(2 * np.pi)))
        else:
            logits = a[0].cpu().numpy()
            p = np.exp(logits - logits.max())
            p /= p.sum()
            with self._rng_lock:
                action = int(self._rng.choice(len(p), p=p))
            logp = float(np.log(p[action] + 1e-12))
        return action, logp, value

    def _record_step(self, eid: str, obs: np.ndarray, action, logp: float,
                     value: float):
        """Commit the episode's previous pending step (its reward is now
        complete) and park the new one.  Flushes a contiguous fragment to
        the training stream when the episode's buffer is long enough."""
        ep = self._episodes.get(eid)
        if ep is None:
            raise KeyError(f"unknown episode {eid!r}")
        ep.started = time.monotonic()
        if not ep.training_enabled:
            return
        if ep.pending is not None:
            ep.steps.append((*ep.pending, ep.pending_reward))
            ep.pending_reward = 0.0
        ep.pending = (obs, np.asarray(action, np.float32), logp, value)
        if len(ep.steps) >= self.fragment_len:
            # truncated fragment: the bootstrap folds into the last reward
            # as gamma * V(next obs), the pending step's value estimate
            o, a, lp, v, r = ep.steps[-1]
            ep.steps[-1] = (o, a, lp, v, r + self.gamma * value)
            self._flush_fragment(ep)

    def _cmd_get_action(self, req):
        eid = req["episode_id"]
        obs = np.asarray(req["observation"], np.float32)
        action, logp, value = self._policy_step(obs)
        with self._steps_ready:
            self._record_step(eid, obs, action, logp, value)
        return {"action": action}

    def _cmd_log_action(self, req):
        """The client computed the action itself (client-side inference via
        get_weights): record the transition with the server's value and
        logp estimates (reference: ``PolicyClient.log_action``)."""
        eid = req["episode_id"]
        obs = np.asarray(req["observation"], np.float32)
        _, logp, value = self._policy_step(obs)
        with self._steps_ready:
            self._record_step(eid, obs, req["action"], logp, value)
        return {}

    def _cmd_log_returns(self, req):
        with self._lock:
            ep = self._episodes.get(req["episode_id"])
            if ep is None:
                raise KeyError(f"unknown episode {req['episode_id']!r}")
            r = float(req["reward"])
            ep.pending_reward += r
            ep.total_reward += r
            ep.started = time.monotonic()
        return {}

    def _cmd_end_episode(self, req):
        truncated = bool(req.get("truncated", False))
        final_obs = req.get("observation")
        bootstrap = 0.0
        if truncated and final_obs is not None:
            # a time-limit truncation is not a true terminal: fold
            # gamma * V(final_obs) into the last reward, as the fragment
            # cut does
            _, _, v = self._policy_step(np.asarray(final_obs, np.float32))
            bootstrap = self.gamma * v
        with self._steps_ready:
            ep = self._episodes.pop(req["episode_id"], None)
            if ep is None:
                raise KeyError(f"unknown episode {req['episode_id']!r}")
            if ep.training_enabled and ep.pending is not None:
                ep.steps.append((*ep.pending,
                                 ep.pending_reward + bootstrap))
                ep.pending = None
                self._flush_fragment(ep)
            self._returns.append(ep.total_reward)
        return {}

    def _cmd_get_weights(self, req):
        with self._lock:
            params, version = self._params, self._params_version
        return {"weights": to_numpy(params), "version": version}

    def _flush_fragment(self, ep: _Episode):
        """Append the episode's committed steps to the training stream as
        one contiguous run ending done=1 (the caller holds the lock)."""
        if not ep.steps:
            return
        n = len(ep.steps)
        for i, (o, a, lp, v, r) in enumerate(ep.steps):
            self._steps.append((o, a, lp, v, r, 1.0 if i == n - 1 else 0.0))
        ep.steps.clear()
        self._steps_ready.notify_all()

    # -------------------------------------------------------- input reader

    def next(self, min_steps: int, timeout: Optional[float] = None
             ) -> Optional[Dict[str, np.ndarray]]:
        """Block until ``min_steps`` committed steps exist; return them as
        one ``[T, 1, ...]`` rollout (reference: ``InputReader.next``), or
        None at ``timeout``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._steps_ready:
            while len(self._steps) < min_steps:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._steps_ready.wait(remaining if remaining is not None
                                       else 1.0)
            take = self._steps[:min_steps]
            del self._steps[:min_steps]
            if take[-1][5] == 0.0 and self._steps:
                # fixed-T slicing cut a fragment: its continuation is
                # self._steps[0] (fragments append atomically, so the
                # stream stays contiguous).  Fold its value estimate into
                # the cut step as the truncation bootstrap and close the
                # sequence; the remainder trains as a fresh sequence.
                o, a, lp, v, r, _ = take[-1]
                v_next = self._steps[0][3]
                take[-1] = (o, a, lp, v, r + self.gamma * v_next, 1.0)
        obs, actions, logp, values, rewards, dones = map(list, zip(*take))
        continuous = getattr(self.model, "continuous", False)
        return {
            "obs": np.stack(obs)[:, None],
            "actions": (np.stack(actions)[:, None] if continuous
                        else np.asarray(actions, np.float32)[:, None]),
            "logp": np.asarray(logp, np.float32)[:, None],
            "values": np.asarray(values, np.float32)[:, None],
            "rewards": np.asarray(rewards, np.float32)[:, None],
            "dones": np.asarray(dones, np.float32)[:, None],
            # every fragment is self-contained (ends done=1 with any
            # truncation bootstrap folded into its last reward), so the
            # stream-level bootstrap is always zero
            "last_values": np.zeros((1,), np.float32),
        }

    def episode_returns(self, clear: bool = True) -> List[float]:
        with self._lock:
            out = list(self._returns)
            if clear:
                self._returns.clear()
        return out

    def set_weights(self, params):
        """Serve ``params`` from the next inference on: a new dict,
        swapped in under the lock."""
        fresh = self._own(params)
        with self._lock:
            self._params = fresh
            self._params_version += 1

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)

    # ------------------------------------------------------------ plumbing

    def _make_handler(self):
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = pickle.loads(self.rfile.read(n))
                    cmd = req["command"].lower()
                    fn = getattr(server, f"_cmd_{cmd}", None)
                    if fn is None:
                        raise ValueError(
                            f"unknown command {req['command']!r}")
                    payload = pickle.dumps(fn(req))
                    self.send_response(200)
                except Exception as e:  # the error goes back to the client
                    payload = pickle.dumps({"error": repr(e)})
                    self.send_response(500)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        return Handler


class PolicyClient:
    """Drive a remote policy server from an external simulator (reference:
    ``policy_client.py:58``; remote-inference mode: for client-side
    inference pull ``get_weights`` and run the model locally)."""

    def __init__(self, address: str, timeout: float = 60.0):
        if "://" not in address:
            address = f"http://{address}"
        self.address = address
        self.timeout = timeout

    def _send(self, command: str, **kwargs) -> Dict[str, Any]:
        import urllib.error
        import urllib.request

        body = pickle.dumps({"command": command, **kwargs})
        req = urllib.request.Request(self.address, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return pickle.loads(resp.read())
        except urllib.error.HTTPError as e:
            payload = pickle.loads(e.read())
            raise RuntimeError(
                f"policy server error: {payload.get('error')}") from None

    def start_episode(self, episode_id: Optional[str] = None,
                      training_enabled: bool = True) -> str:
        return self._send("start_episode", episode_id=episode_id,
                          training_enabled=training_enabled)["episode_id"]

    def get_action(self, episode_id: str, observation):
        return self._send("get_action", episode_id=episode_id,
                          observation=np.asarray(observation))["action"]

    def log_action(self, episode_id: str, observation, action):
        self._send("log_action", episode_id=episode_id,
                   observation=np.asarray(observation), action=action)

    def log_returns(self, episode_id: str, reward: float):
        self._send("log_returns", episode_id=episode_id, reward=float(reward))

    def end_episode(self, episode_id: str, observation=None,
                    truncated: bool = False):
        """``truncated=True`` with the final observation marks a time-limit
        end: the server folds ``gamma * V(observation)`` into the last
        reward instead of treating it as a true terminal."""
        self._send("end_episode", episode_id=episode_id,
                   observation=(None if observation is None
                                else np.asarray(observation)),
                   truncated=truncated)

    def get_weights(self):
        out = self._send("get_weights")
        return out["weights"], out["version"]
