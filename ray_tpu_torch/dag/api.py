"""Compiled-DAG API: static actor graphs with resident loops.

The port's copy of ``ray_tpu/dag/api.py`` on the port's runtime.

Linear pipeline::

    dag = compile_pipeline([(actor1, "preprocess"), (actor2, "infer")])
    out = dag.execute(x)     # microsecond-scale dispatch per call
    dag.teardown()

General graphs (fan-out / fan-in, reference:
python/ray/dag/compiled_dag_node.py:482 + dag_node_operation.py)::

    with InputNode() as inp:
        a = bind(actor_a, "left", inp)
        b = bind(actor_b, "right", inp)
        c = bind(actor_c, "join", a, b)      # diamond
    dag = compile_dag(c)
    out = dag.execute(x)

Each stage's actor runs a resident loop (reference: the compiled DAG's
per-actor executable loop, compiled_dag_node.py:92) reading ALL its input
channels in a fixed order, invoking the bound method with those values,
and writing the result to every consumer's channel. Execution never
touches the scheduler. Same-node edges ride seqno-gated shm channels
(microseconds); an edge between two stages of one GPU actor may ride a
``DeviceChannel`` instead, which hands CUDA tensors over by reference
(``device=``: "auto" for GPU actors, "force" for any same-process edge,
"off" for none). CROSS-NODE edges ride framed TCP channels with the
same rendezvous semantics (dag/channel.py:SocketChannel), so a graph may
span the cluster. Stages run in PIPELINE: call N+1 may enter stage 1
while call N is downstream.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import ray_tpu_torch
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.config import config
from ray_tpu_torch.dag.channel import (Channel, ChannelClosed,
                                       DeviceChannel, SocketChannel,
                                       open_endpoint)
from ray_tpu_torch.exceptions import ActorError
from ray_tpu_torch.util.debug_lock import make_lock


class InputNode:
    """Placeholder for the DAG input (parity with the reference's
    `with InputNode() as inp:` style)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class MultiOutputNode:
    """Declare several stages as the DAG's outputs; execute() returns a
    list in this order (reference: ray.dag.MultiOutputNode)."""

    def __init__(self, nodes: Sequence["_BoundStage"]):
        self.nodes = list(nodes)


class _BoundStage:
    __slots__ = ("actor", "method", "upstreams")

    def __init__(self, actor, method: str, upstreams):
        self.actor = actor
        self.method = method
        self.upstreams = list(upstreams)

    def experimental_compile(self, capacity: int = 1 << 20,
                             spin_us: Optional[int] = None,
                             device: Optional[str] = None) -> "CompiledDag":
        return compile_dag(self, capacity=capacity, spin_us=spin_us,
                           device=device)


def bind(actor, method: str, *upstreams) -> _BoundStage:
    """actor.method(*upstreams) as a DAG node; leaves are InputNodes."""
    if not upstreams:
        raise ValueError("bind needs at least one upstream")
    return _BoundStage(actor, method, upstreams)


def _actor_id_of(actor):
    return actor._actor_id if hasattr(actor, "_actor_id") else actor


class CompiledDag:
    """A compiled static graph. One channel per EDGE; the driver owns the
    input-edge writers and output-edge readers."""

    def __init__(self, output, capacity: int = 1 << 20,
                 spin_us: Optional[int] = None,
                 device: Optional[str] = None):
        outputs = (output.nodes if isinstance(output, MultiOutputNode)
                   else [output])
        if not outputs or not all(isinstance(o, _BoundStage)
                                  for o in outputs):
            raise ValueError("compile_dag needs _BoundStage output(s)")
        # channel-wait mode: busy-poll budget before the condvar fallback
        # (descriptors carry it, so stage loops and driver endpoints both
        # ride the spin lane); 0 = pure block
        self._spin_us = max(0, int(config.dag_spin_us if spin_us is None
                                   else spin_us))
        dev_mode = (config.dag_device_channels if device is None
                    else device)
        if dev_mode not in ("off", "auto", "force"):
            raise ValueError(
                f"dag_device_channels must be off/auto/force, "
                f"got {dev_mode!r}")
        core = runtime_context.get_core()
        self._core = core
        self._store = getattr(core, "store", None) \
            or getattr(core, "_home_store", None)
        self._kv = core.kv_op
        # socket-channel auth rides the cluster authkey; the driver holds
        # it programmatically (env may be unset in test drivers)
        self._chan_authkey = getattr(core, "_authkey", None)

        # ---- collect stages in topological order (DFS postorder) ----
        stages: List[_BoundStage] = []
        seen: Dict[int, bool] = {}

        def visit(node):
            if isinstance(node, InputNode):
                return
            if id(node) in seen:
                if not seen[id(node)]:
                    raise ValueError("DAG has a cycle")
                return
            seen[id(node)] = False
            for up in node.upstreams:
                visit(up)
            seen[id(node)] = True
            stages.append(node)

        for o in outputs:
            visit(o)
        self._stages = stages

        # ---- placement: which node hosts each endpoint ----
        def node_of(actor, method: str = "?") -> Any:
            import time as _time

            from ray_tpu_torch.core.cluster.rpc import RpcError

            aid = _actor_id_of(actor)
            fn = getattr(core, "_actor_addr", None)
            if fn is None:
                return "local"  # embedded runtime: everything same-node
            # bounded retry on the TYPED lookup failures only (actor
            # registration racing compile, or a GCS blip): anything else
            # is a real bug and propagates immediately. An actor that
            # never appears within the deadline fails the COMPILE loudly
            # (a guessed host would surface as an undiagnosable
            # execute() timeout instead).
            wait_s = config.dag_compile_actor_wait_s
            deadline = _time.monotonic() + wait_s
            last: Any = None
            while True:
                try:
                    return tuple(fn(aid))
                except (ActorError, RpcError) as e:
                    last = e
                    if _time.monotonic() >= deadline:
                        break
                    _time.sleep(0.05)
            raise ValueError(
                f"cannot compile DAG: actor {aid} (stage .{method}) has "
                f"no known node after {wait_s:.1f}s "
                f"(dead, or never registered; raise "
                f"dag_compile_actor_wait_s if creation is slow): "
                f"{last!r}") from last

        # ---- device placement probe: (pid, is_gpu) per actor ----
        # tensors can only be handed off by reference INSIDE one process
        # (one actor per worker), so a device edge requires both stages
        # bound to the same actor process.
        devinfo_cache: Dict[Any, tuple] = {}

        def devinfo(actor) -> tuple:
            aid = _actor_id_of(actor)
            if aid not in devinfo_cache:
                try:
                    ref = core.submit_actor_task(
                        aid, "__rtpu_dag_devinfo__", (), {}, 1)[0]
                    devinfo_cache[aid] = tuple(
                        ray_tpu_torch.get(ref, timeout=30))
                except Exception:  # noqa: BLE001 — probe is best-effort:
                    # any failure just means "no device edge", shm works
                    devinfo_cache[aid] = (None, False)
            return devinfo_cache[aid]
        driver_node = getattr(core, "_home", "local")
        if driver_node != "local":
            driver_node = tuple(driver_node)

        # ---- one channel per edge ----
        # edge key: (producer id | "input", consumer id); descriptor dicts
        # are shipped to the stage loops. Driver-attached edges to SAME
        # node use shm; everything else (incl. actor<->actor off the
        # driver's node) uses socket channels — shm needs both ends
        # mapped into the driver's arena.
        self._in_edges: List[Any] = []      # driver-side writer endpoints
        self._out_edges: List[Any] = []     # driver-side reader endpoints
        stage_in: Dict[int, List] = {id(s): [] for s in stages}
        stage_out: Dict[int, List] = {id(s): [] for s in stages}

        def make_edge(prod_node, cons_node, prod_actor=None,
                      cons_actor=None):
            same = (prod_node == cons_node == driver_node
                    or prod_node == cons_node == "local")
            if same and self._store is not None:
                # on-device edge: both stages in ONE actor process, a GPU
                # actor ('force' skips the GPU check so the handoff is
                # testable on the CPU); anything else transparently falls
                # back to a plain shm channel
                if (dev_mode != "off" and prod_actor is not None
                        and cons_actor is not None):
                    p_pid, p_gpu = devinfo(prod_actor)
                    c_pid, c_gpu = devinfo(cons_actor)
                    if (p_pid is not None and p_pid == c_pid
                            and (dev_mode == "force"
                                 or (p_gpu and c_gpu))):
                        dch = DeviceChannel.create(self._store, capacity,
                                                   self._spin_us)
                        return dch.descriptor(), dch
                ch = Channel.create(self._store, capacity, self._spin_us)
                return ch.descriptor(), ch
            # descriptor carries the READER's (consumer's) node host, the
            # address that node advertises: the reader publishes only its
            # port to the KV
            host = (cons_node[0] if isinstance(cons_node, tuple)
                    else "127.0.0.1")
            cid = SocketChannel.create_id()
            return ("sock", cid, host), None

        self._shm_chans: List[Channel] = []
        self._inputs: List[Any] = []
        self._outputs: List[Any] = []
        try:
            for s in stages:
                s_node = node_of(s.actor, s.method)
                for up in s.upstreams:
                    if isinstance(up, InputNode):
                        desc, ch = make_edge(driver_node, s_node)
                        stage_in[id(s)].append(desc)
                        self._in_edges.append((desc, ch))
                    else:
                        desc, ch = make_edge(node_of(up.actor, up.method),
                                             s_node, prod_actor=up.actor,
                                             cons_actor=s.actor)
                        stage_in[id(s)].append(desc)
                        stage_out[id(up)].append(desc)
                        if ch is not None:
                            self._shm_chans.append(ch)
            for o in outputs:
                desc, ch = make_edge(node_of(o.actor, o.method),
                                     driver_node)
                stage_out[id(o)].append(desc)
                self._out_edges.append((desc, ch))

            # Separate writer/reader locks: a write blocked on the input
            # channel's ack gate (pipeline at capacity) must not stop a
            # reader from draining the output channel — that drain is
            # what unblocks it. Routed through the lock factory so
            # RTPU_SANITIZE=1 puts this pairing under the runtime
            # lock-order sanitizer.
            self._wlock = make_lock("dag.CompiledDag._wlock")
            self._rlock = make_lock("dag.CompiledDag._rlock")
            self._down = False
            self._broken = False
            self._n_out = len(outputs)
            self._single = not isinstance(output, MultiOutputNode)

            # ---- start the resident loops ----
            acks = []
            for s in stages:
                acks.append(core.submit_actor_task(
                    _actor_id_of(s.actor), "__rtpu_dag_start__",
                    (stage_in[id(s)], stage_out[id(s)], s.method),
                    {}, 1)[0])
            for ref in acks:
                assert ray_tpu_torch.get(ref, timeout=60) == "ok"

            # driver endpoints (socket endpoints rendezvous lazily; stage
            # loops are already up, so their reader sides publish;
            # appended one at a time so a failed rendezvous can still
            # release the endpoints opened before it)
            for desc, ch in self._in_edges:
                self._inputs.append(
                    ch if ch is not None else
                    open_endpoint(desc, kv=self._kv, role="writer",
                                  authkey=self._chan_authkey))
            for desc, ch in self._out_edges:
                self._outputs.append(
                    ch if ch is not None else
                    open_endpoint(desc, kv=self._kv, role="reader",
                                  authkey=self._chan_authkey))
        except BaseException:
            # half-built DAG: teardown() never runs for an object whose
            # __init__ raised, so release every channel endpoint created
            # so far — their shm pins would otherwise outlive the failed
            # compile until store close
            edge_chs = [c for _, c in self._in_edges + self._out_edges
                        if c is not None] + self._shm_chans
            opened = [c for c in self._inputs + self._outputs
                      if all(c is not e for e in edge_chs)]
            for c in edge_chs + opened:
                try:
                    c.release()
                # rtpu-lint: disable=L4 — best-effort unwind of a failed
                # compile; the original error is what must surface
                except Exception:  # noqa: BLE001
                    pass
            raise

    # ------------------------------------------------------------- calls

    def _check_usable(self):
        if self._down:
            raise RuntimeError("DAG was torn down")
        if self._broken:
            raise RuntimeError(
                "DAG is broken (a previous call timed out, so the "
                "request/response pairing is no longer trustworthy); "
                "teardown and recompile")

    def _read_outs(self, timeout_ms: int):
        """FIFO-ordered output read; a timeout poisons the DAG — the
        unconsumed in-flight result would otherwise be returned to the
        NEXT caller (off-by-one forever)."""
        vals = []
        try:
            for ch in self._outputs:
                vals.append(ch.read(timeout_ms=timeout_ms))
        except TimeoutError:
            self._broken = True
            raise
        return vals

    def execute(self, value: Any, timeout_ms: int = 60_000) -> Any:
        """Synchronous call through the graph."""
        from ray_tpu_torch.dag.channel import _chan_dumps

        data = _chan_dumps(("v", value))  # serialize ONCE for the fan-out
        with self._wlock:
            self._check_usable()
            for ch in self._inputs:
                ch.write_raw(data, timeout_ms=timeout_ms)
        with self._rlock:
            outs = self._read_outs(timeout_ms)
        vals = []
        for tag, out in outs:
            if tag == "e":
                raise out
            vals.append(out)
        return vals[0] if self._single else vals

    def execute_async(self, value: Any, timeout_ms: int = 60_000):
        """Returns a 0-arg callable resolving the result (the next read).
        Calls resolve in FIFO order; useful to overlap pipeline stages."""
        from ray_tpu_torch.dag.channel import _chan_dumps

        data = _chan_dumps(("v", value))
        with self._wlock:
            self._check_usable()
            for ch in self._inputs:
                ch.write_raw(data, timeout_ms=timeout_ms)

        def resolve():
            with self._rlock:
                outs = self._read_outs(timeout_ms)
            vals = []
            for tag, out in outs:
                if tag == "e":
                    raise out
                vals.append(out)
            return vals[0] if self._single else vals
        return resolve

    def teardown(self):
        with self._wlock:
            if self._down:
                return
            self._down = True
        try:
            for ch in self._inputs:
                ch.close()
            # close sentinels cascade through every stage loop; drain
            # each output until ITS sentinel (ChannelClosed) arrives —
            # pipelined calls still in flight at teardown would otherwise
            # leave sealed messages (and their shm slots) behind, since a
            # single read consumes at most one of them
            with self._rlock:
                for ch in self._outputs:
                    try:
                        while True:
                            ch.read(timeout_ms=5000)
                    except ChannelClosed:
                        pass  # fully drained
                    except Exception:  # noqa: BLE001 — draining best-effort
                        pass
        finally:
            with self._rlock:
                chans = self._inputs + self._outputs + self._shm_chans
            for ch in chans:
                ch.release()


def compile_dag(output, capacity: int = 1 << 20,
                spin_us: Optional[int] = None,
                device: Optional[str] = None) -> CompiledDag:
    """Compile a bound graph (single output node or MultiOutputNode).

    ``spin_us`` is the per-wait busy-poll budget before the condvar
    fallback (None = ``config.dag_spin_us``; 0 = pure block).
    ``device`` selects on-device edges: off/auto/force
    (None = ``config.dag_device_channels``)."""
    return CompiledDag(output, capacity=capacity, spin_us=spin_us,
                       device=device)


def compile_pipeline(stages: Sequence[Tuple[Any, str]],
                     capacity: int = 1 << 20,
                     spin_us: Optional[int] = None,
                     device: Optional[str] = None) -> CompiledDag:
    """Linear chain convenience over compile_dag."""
    node: Any = InputNode()
    for actor, method in stages:
        node = _BoundStage(actor, method, [node])
    return compile_dag(node, capacity=capacity, spin_us=spin_us,
                       device=device)
