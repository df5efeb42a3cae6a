"""External-env policy serving: train from environments that live
OUTSIDE the cluster.

Reference: rllib/env/policy_server_input.py (server side) and
rllib/env/policy_client.py (client side). An external process — a game,
a simulator farm, a production system — connects over the cluster RPC
plane (authkey'd framed-pickle TCP, the same substrate the node/GCS
links ride), asks the server for actions, and reports rewards. The
server runs inference with the CURRENT weights, logs the transitions,
and hands the trainer time-major [T, 1] batches in the same schema the
IMPALA/APPO learners consume — so off-policy correction covers the
client's action-to-training lag exactly like runner lag. The learner
that consumes the batches is the caller's, on the card unless it was
built with ``device="cpu"``.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core.cluster.rpc import RpcClient, RpcServer
from ray_tpu_torch.rllib.rl_module import build_pv_module, to_numpy


class PolicyServerInput:
    """Action server + transition collector for external envs."""

    def __init__(self, module_spec: dict, host: str = "127.0.0.1",
                 port: int = 0, authkey: Optional[bytes] = None,
                 seed: int = 0):
        # the server acts in numpy (``apply_np``) on the weights the
        # trainer pushes; its first weights are drawn on the CPU
        self.module = build_pv_module(module_spec)
        self._weights = to_numpy(self.module.init_params(seed, "cpu"))
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._episodes: Dict[str, dict] = {}   # eid -> open step state
        self._steps: collections.deque = collections.deque()
        self._returns: collections.deque = collections.deque(maxlen=64)
        self._next_eid = 0
        self._authkey = authkey or os.urandom(16)
        self._server = RpcServer(self._handle, self._authkey,
                                 host=host, port=port)
        self.address = self._server.address

    @property
    def authkey(self) -> bytes:
        return self._authkey

    # ------------------------------------------------------------ RPC side

    def _handle(self, msg, ctx):
        op = msg[0]
        if op == "start_episode":
            import time as _time

            with self._lock:
                # GC abandoned episodes (client died mid-episode): a
                # long-lived serving deployment must not leak one dict
                # (plus pending obs/logits) per crashed client
                now = _time.monotonic()
                for eid in [e for e, st in self._episodes.items()
                            if now - st.get("ts", now) > 600.0]:
                    del self._episodes[eid]
                while len(self._episodes) > 4096:
                    self._episodes.pop(next(iter(self._episodes)))
                eid = f"ep_{self._next_eid}"
                self._next_eid += 1
                self._episodes[eid] = {"pending": None, "return": 0.0,
                                       "ts": now}
            return eid
        if op == "get_action":
            _, eid, obs = msg
            obs = np.asarray(obs, np.float32)
            logits, _ = self.module.apply_np(self._weights, obs[None])
            logits = logits[0]
            g = self._rng.gumbel(size=logits.shape)
            action = int(np.argmax(logits + g))
            import time as _time

            with self._lock:
                ep = self._episodes[eid]
                ep["ts"] = _time.monotonic()
                self._close_step(ep, next_obs=obs, done=False)
                ep["pending"] = {"obs": obs, "action": action,
                                 "logits": logits, "reward": 0.0}
            return action
        if op == "log_returns":
            _, eid, reward = msg
            with self._lock:
                ep = self._episodes[eid]
                if ep["pending"] is not None:
                    ep["pending"]["reward"] += float(reward)
                ep["return"] += float(reward)
            return True
        if op == "end_episode":
            _, eid, last_obs = msg
            with self._lock:
                ep = self._episodes.pop(eid)
                self._close_step(ep, np.asarray(last_obs, np.float32),
                                 done=True)
                self._returns.append(ep["return"])
            return True
        if op == "ping":
            return "pong"
        raise ValueError(f"unknown policy-server op {op!r}")

    def _close_step(self, ep: dict, next_obs: np.ndarray, done: bool):
        """The previous pending step learns its successor (lock held)."""
        p = ep["pending"]
        if p is None:
            return
        self._steps.append((p["obs"], next_obs, p["action"], p["logits"],
                            p["reward"], done, done))
        ep["pending"] = None

    # -------------------------------------------------------- trainer side

    def set_weights(self, weights):
        self._weights = weights

    def steps_ready(self) -> int:
        return len(self._steps)

    def episode_returns(self) -> List[float]:
        with self._lock:
            out = list(self._returns)
            self._returns.clear()
        return out

    def next_batch(self, rollout_len: int) -> Optional[Dict[str, Any]]:
        """[T, 1] time-major batch in the IMPALA/APPO learner schema, or
        None until enough client steps accumulated."""
        with self._lock:
            if len(self._steps) < rollout_len:
                return None
            steps = [self._steps.popleft() for _ in range(rollout_len)]
        obs, nxt, act, logits, rew, term, done = zip(*steps)
        return {
            "obs": np.stack(obs)[:, None, :],
            "next_obs": np.stack(nxt)[:, None, :],
            "actions": np.asarray(act, np.int32)[:, None],
            "behavior_logits": np.stack(logits)[:, None, :],
            "rewards": np.asarray(rew, np.float32)[:, None],
            "terminateds": np.asarray(term, bool)[:, None],
            "dones": np.asarray(done, bool)[:, None],
        }

    def close(self):
        self._server.close()


class PolicyClient:
    """External-process client (reference: rllib/env/policy_client.py).

    Drives episodes against a remote PolicyServerInput:

        client = PolicyClient(addr, authkey)
        eid = client.start_episode()
        a = client.get_action(eid, obs)
        client.log_returns(eid, reward)
        client.end_episode(eid, last_obs)
    """

    def __init__(self, address: Tuple[str, int], authkey: bytes):
        self._client = RpcClient(tuple(address), authkey)

    def start_episode(self) -> str:
        return self._client.call(("start_episode",))

    def get_action(self, episode_id: str, obs) -> int:
        return self._client.call(
            ("get_action", episode_id,
             np.asarray(obs, np.float32).tolist()))

    def log_returns(self, episode_id: str, reward: float):
        self._client.call(("log_returns", episode_id, float(reward)))

    def end_episode(self, episode_id: str, obs):
        self._client.call(
            ("end_episode", episode_id,
             np.asarray(obs, np.float32).tolist()))

    def close(self):
        self._client.close()
