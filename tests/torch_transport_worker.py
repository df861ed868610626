"""Executor processes of the transport twins (tests/test_torch_transport.py,
tests/test_torch_failure.py): one shuffle manager of either package over
its own ``TcpNetwork``, the counterparts of the children of
tests/test_tcp.py and tests/test_tcp_chaos.py.

``root`` names the package (``sparkrdma_tpu`` or ``sparkrdma_tpu_torch``);
the module imports it only inside the child, so a port child loads no JAX.
"""

import importlib
import random

PORT = "sparkrdma_tpu_torch"
NUM_PARTS = 4
ROWS_PER_MAP = 250
VAL_BYTES = 2048


def package(root):
    """(TpuShuffleConf, TpuShuffleManager, HashPartitioner, TcpNetwork) of
    one package."""
    imp = importlib.import_module
    return (imp(f"{root}.conf").TpuShuffleConf,
            imp(f"{root}.shuffle.manager").TpuShuffleManager,
            imp(f"{root}.shuffle.partitioner").HashPartitioner,
            imp(f"{root}.transport").TcpNetwork)


def manager_kw(root, stage):
    """The port's managers run on the CPU here."""
    kw = {"stage_to_device": stage}
    if root == PORT:
        kw["device"] = "cpu"
    return kw


def tcp_conf(driver_port):
    return {
        "spark.shuffle.tpu.driverPort": driver_port,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "10s",
        "spark.shuffle.tpu.connectTimeout": "5s",
    }


def executor_main(root, stage, idx, driver_port, my_port, done, failed):
    """tests/test_tcp.py's child: write map ``idx`` of shuffle 7 and serve
    it until ``done``."""
    try:
        Conf, Manager, Hash, Tcp = package(root)
        ex = Manager(Conf(tcp_conf(driver_port)), is_driver=False,
                     network=Tcp(), port=my_port, executor_id=str(idx),
                     **manager_kw(root, stage))
        handle = ex.register_shuffle(7, 2, Hash(4))
        w = ex.get_writer(handle, idx)
        w.write([(f"w{idx}-{j}", j) for j in range(30)])
        w.stop(True)
        done.wait(timeout=60)
        ex.stop()
    except BaseException:
        failed.set()
        raise


def chaos_records(sid, map_id):
    """tests/test_tcp_chaos.py's records of (shuffle, map): KB-scale
    values, so a SIGKILL can land inside one block."""
    rng = random.Random(sid * 7919 + map_id)
    return [(f"s{sid}m{map_id}r{j}", bytes([rng.randrange(256)]) * VAL_BYTES)
            for j in range(ROWS_PER_MAP)]


def chaos_conf(driver_port, extra=None):
    return {
        "spark.shuffle.tpu.driverPort": driver_port,
        "spark.shuffle.tpu.partitionLocationFetchTimeout": "12s",
        "spark.shuffle.tpu.connectTimeout": "5s",
        "spark.shuffle.tpu.heartbeatInterval": "300ms",
        "spark.shuffle.tpu.heartbeatTimeout": "2s",
        **(extra or {}),
    }


def chaos_executor(root, stage, exec_id, driver_port, my_port, cmd_q, ack_q,
                   extra_conf=None):
    """tests/test_tcp_chaos.py's child: one manager driven by ``(op, ...)``
    commands; a SIGKILL may land anywhere here."""
    try:
        Conf, Manager, Hash, Tcp = package(root)
        ex = Manager(Conf(chaos_conf(driver_port, extra_conf)),
                     is_driver=False, network=Tcp(), port=my_port,
                     executor_id=exec_id, **manager_kw(root, stage))
        ack_q.put(("up", exec_id, ex.node.address[1]))
        while True:
            cmd = cmd_q.get()
            if cmd[0] == "quit":
                ex.stop()
                ack_q.put(("bye", exec_id))
                return
            if cmd[0] == "write":
                _op, sid, n_maps, map_ids = cmd
                handle = ex.register_shuffle(sid, n_maps, Hash(NUM_PARTS))
                for m in map_ids:
                    w = ex.get_writer(handle, m)
                    w.write(chaos_records(sid, m))
                    w.stop(True)
                ack_q.put(("wrote", exec_id, sid))
    except BaseException as e:
        try:
            ack_q.put(("err", exec_id, repr(e)))
        except Exception:
            pass
        raise
