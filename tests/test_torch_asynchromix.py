"""The port's AsynchroMix app (apps/asynchromix.py, apps/evm_double.py,
utils/misc.py) and its first tutorial, on the CPU.

The coordinator double is the reference's, copied: its code equals
``apps/evm_double.py`` but for the module text, its state machine passes
the reference's own test, and every function and event exists in the
shipped ``apps/contracts/AsynchromixCoordinator.sol``. One event-driven
epoch (clients reserve masks and publish masked inputs, servers report
preprocessing, a mix is initiated on-chain, the MPC runs, t+1 votes
certify the output) runs at n=4, t=1, k=4 for both mixes, the butterfly
network and power mixing; ``tutorial_1`` runs on the CPU; ``FpArray.to_int``
agrees with the reference's."""

import ast
import asyncio
import os

import numpy as np
import pytest

from _jax_memory import release_jax_memory  # noqa: F401
from _torch_threads import one_torch_thread  # noqa: F401
from _runtime_parity import ints
from honeybadgermpc_tpu_torch.apps import asynchromix, evm_double, tutorial_1
from honeybadgermpc_tpu_torch.apps.evm_double import (AsynchromixCoordinator,
                                                      Revert)
from honeybadgermpc_tpu_torch.ops.fparray import FpArray
from honeybadgermpc_tpu_torch.ops.limbs import P
from honeybadgermpc_tpu_torch.utils.misc import print_exception_callback

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _body(path):
    """A module's source without its docstring, as an AST dump."""
    tree = ast.parse(open(path).read())
    tree.body = tree.body[1:]
    return ast.dump(tree)


def test_evm_double_is_the_reference_copy():
    assert _body(evm_double.__file__) == \
        _body(os.path.join(REPO, "apps", "evm_double.py"))


def test_coordinator_contract_state_machine():
    """The reference's test_apps.py case on the port's double: min-consensus
    preprocessing reports, authorized single-use masks, K-input epoch
    initiation, and t+1 matching votes to certify an output."""
    servers = [f"s{i}" for i in range(4)]
    c = AsynchromixCoordinator(servers, t=1, k=4)

    with pytest.raises(Revert):
        c.preprocess_report([9, 9, 9], sender="not-a-server")
    for s in servers[:3]:
        c.preprocess_report([8, 8, 9], sender=s)
    assert c.inputmasks_available() == 0        # server 3 hasn't reported
    c.preprocess_report([8, 8, 5], sender=servers[3])
    assert c.inputmasks_available() == 5
    assert c.mixes_available() == 1             # PER_MIX = (4/2)*2*2 = 8

    with pytest.raises(Revert):
        c.submit_message(0, 123, sender="alice")
    r = c.reserve_inputmask(sender="alice")
    idx = r.events[0].args["inputmask_idx"]
    assert c.client_authorized("alice", idx) and not \
        c.client_authorized("bob", idx)
    with pytest.raises(Revert):
        c.submit_message(idx, 123, sender="bob")
    c.submit_message(idx, 123, sender="alice")
    with pytest.raises(Revert):                 # single use
        c.submit_message(idx, 456, sender="alice")

    with pytest.raises(Revert):
        c.initiate_mix()
    for j in range(3):
        i2 = c.reserve_inputmask(
            sender=f"c{j}").events[0].args["inputmask_idx"]
        c.submit_message(i2, 1000 + j, sender=f"c{j}")
    c.initiate_mix()
    assert c.epochs_initiated == 1
    assert c.get_events("MixingEpochInitiated")[0].args["epoch"] == 0
    assert c.mixes_available() == 0             # budget consumed

    c.propose_output(0, "a,b", sender=servers[0])
    assert c.outputs_ready == 0
    with pytest.raises(Revert):                 # no double voting
        c.propose_output(0, "a,b", sender=servers[0])
    with pytest.raises(Revert):                 # conflicting output
        c.propose_output(0, "x,y", sender=servers[1])
    c.propose_output(0, "a,b", sender=servers[1])
    assert c.outputs_ready == 1
    assert c.get_events("MixOutput")[0].args["output"] == "a,b"


def test_coordinator_surface_matches_sol_artifact():
    """Every function and event the port's double exposes exists in the
    shipped contract artifact (read as a data file)."""
    sol = open(os.path.join(
        REPO, "apps", "contracts", "AsynchromixCoordinator.sol")).read()
    for fn in ("preprocess_report", "inputmasks_available",
               "reserve_inputmask", "client_authorized", "submit_message",
               "input_queue_length", "inputs_ready", "mixes_available",
               "initiate_mix", "propose_output"):
        assert hasattr(AsynchromixCoordinator, fn), fn
        assert f"function {fn}" in sol, fn
    for ev in ("PreProcessUpdated", "InputMaskClaimed", "MessageSubmitted",
               "MixingEpochInitiated", "MixOutput"):
        assert f"event {ev}" in sol, ev
    for const in ("K", "PER_MIX_TRIPLES", "PER_MIX_BITS"):
        assert const in sol, const
        assert hasattr(AsynchromixCoordinator([1, 2, 3, 4], 1, 4), const)


@pytest.mark.parametrize("mix", ["butterfly", "powers"])
def test_event_driven_epoch(mix):
    """Full client -> contract -> server flow, one epoch at n=4, t=1, k=4:
    the certified output is the sorted message set."""
    messages, mixed = asyncio.run(asyncio.wait_for(
        asynchromix.run_one_epoch(n=4, t=1, k=4, seed=13, mix=mix,
                                  device="cpu"), 120))
    assert mixed == sorted(messages)


def test_main_runs_one_epoch(capsys):
    asynchromix.main(["--device", "cpu", "--k", "4", "--mix", "powers"])
    assert "mixed correctly by the powers mix" in capsys.readouterr().out


def test_server_group_masks_and_refusal():
    """Each server's mask share interpolates to the mask; an unauthorized
    client is refused; the mock coordinator batches k messages."""
    group = asynchromix.ServerGroupSim(4, 1, 4, seed=5, device="cpu")
    group.deal_masks(3)
    coord = AsynchromixCoordinator([f"s{i}" for i in range(4)], 1, k=4)
    server = asynchromix.AsynchromixServer(0, coord, "s0", group)
    with pytest.raises(PermissionError):
        asyncio.run(server.req_mask("eve", 0))
    client = asynchromix.AsynchromixClient("c", coord, [server])
    shares = [group.mask_share(i, 2) for i in range(4)]
    mask = int(client.poly.interpolate_at([(1, shares[0]), (2, shares[1])],
                                          0))
    want = group.ctx.open_share_array(group.ctx.ShareArray(
        FpArray(group._masks.limbs[:, :, 2:3])))
    assert mask == FpArray(want.limbs[:, 0, 0]).to_int()
    mock = asynchromix.MockCoordinator(2)
    for v in (10, 11, 12):
        mock.submit_message(mock.reserve_input_mask(), v)
    assert mock.ready_epoch() == [(0, 10), (1, 11)]
    assert mock.ready_epoch() is None


def test_print_exception_callback_reraises():
    async def boom():
        raise ValueError("boom")

    async def run():
        task = asyncio.ensure_future(boom())
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        with pytest.raises(ValueError):
            print_exception_callback(task)

    asyncio.run(run())


def test_tutorial_1_on_the_cpu(capsys):
    tutorial_1.main("cpu")
    out = capsys.readouterr().out
    assert out.split("\n")[:3] == ["beaver multiply: ok", "secret switch: ok",
                                   "dot product: ok"]


def test_to_int_equals_the_reference():
    """FpArray.to_int on one element: the reference's value from the same
    Montgomery words."""
    import jax.numpy as jnp

    from honeybadgermpc_tpu.ops.fparray import FpArray as RefFpArray
    from honeybadgermpc_tpu_torch.interop import to_reference_limbs
    for v in ints(90, 3) + [0, 1, P - 1]:
        port = FpArray.from_ints([v], device="cpu")[0]
        ref = RefFpArray(jnp.asarray(to_reference_limbs(port.limbs)))
        assert port.to_int() == ref.to_int() == v
    with pytest.raises(AssertionError):
        FpArray.from_ints([1, 2], device="cpu").to_int()
    assert np.asarray(FpArray.from_ints([[7]], device="cpu")[0, 0]
                      .to_int()) == 7
