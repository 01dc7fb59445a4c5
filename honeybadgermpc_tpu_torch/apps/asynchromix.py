"""AsynchroMix: client-input mixing service coordinated by a contract
(reference apps/asynchromix/asynchromix.py:55-562 + asynchromix.sol).

Counterpart of ``apps/asynchromix.py``. Event-driven: clients and servers
interact ONLY through the coordinator contract's calls and emitted events —
reserve an input mask (InputMaskClaimed), publish the masked message
(MessageSubmitted), watch MixingEpochInitiated to run the epoch's MPC, and
vote outputs until t+1 agree (MixOutput). The contract artifact ships at
``apps/contracts/AsynchromixCoordinator.sol``; its state machine runs
in-process (``evm_double.py``) — the drivers here only see the call +
event-log surface a chain offers.

The MPC side is the port's runtime: masks from its dealer, per-epoch mixing
via the butterfly network or power mixing on the card's kernels (``cuda``
unless the caller passes ``device="cpu"``).

Run: python -m honeybadgermpc_tpu_torch.apps.asynchromix  (one epoch;
``--help`` for the sizes, the mix and the device)
"""

from __future__ import annotations

import argparse
import asyncio
import math
import random

import torch

from ..elliptic_curve import Subgroup
from ..field import GF
from ..models.butterfly import iterated_butterfly_network_jit
from ..models.powermixing import power_mix
from ..ops.fparray import FpArray
from ..polynomial import polynomials_over
from ..runtime.context import MpcContext
from ..runtime.preprocessing import PreProcessedElements
from ..utils.misc import print_exception_callback
from .evm_double import AsynchromixCoordinator, Revert

P = Subgroup.BLS12_381
POLL = 0.005   # reference loops poll every 5 s on-chain; sim polls fast


class MockCoordinator:
    """Minimal synchronous double (kept as the unit-test stand-in; the
    event-driven flow below uses evm_double.AsynchromixCoordinator)."""

    def __init__(self, k_per_epoch: int):
        self.k = k_per_epoch
        self.next_mask = 0
        self.queue = []
        self.epochs = []

    def reserve_input_mask(self) -> int:
        idx = self.next_mask
        self.next_mask += 1
        return idx

    def submit_message(self, mask_idx: int, masked_value: int):
        self.queue.append((mask_idx, masked_value))

    def ready_epoch(self):
        if len(self.queue) >= self.k:
            batch, self.queue = self.queue[:self.k], self.queue[self.k:]
            return batch
        return None


class ServerGroupSim:
    """Single-host simulation of the n servers' shared MPC state: dealt
    share tensors plus the per-epoch mix computed once (every server
    proposes the result from its own view). In a real deployment each
    server holds one share slice and the mix runs over the network; the
    contract-facing drivers (below) are identical either way."""

    def __init__(self, n, t, k_per_epoch, seed=0, mix="butterfly",
                 device=torch.device("cuda")):
        self.n, self.t, self.k = n, t, k_per_epoch
        self.mix = mix
        self.device = torch.device(device)
        self.rounds = int(math.log2(k_per_epoch)) ** 2
        self.pre = PreProcessedElements(n, t, seed=seed, device=self.device)
        self.ctx = MpcContext(n, t, preproc=self.pre, device=self.device)
        self.mask_count = 0
        self.mix_budget = 0          # epochs' worth of triples/bits dealt
        self._masks = None           # FpArray [n, mask_count]
        self._mix_results = {}       # epoch -> sorted plaintexts
        if mix == "powers":
            self.pre.generate_powers(k_per_epoch, k_per_epoch)

    # -- offline phase (the servers' preprocessing runs, reference
    # _offline_inputmasks_loop / _offline_mixes_loop) --------------------
    def deal_masks(self, count: int) -> int:
        self.pre.generate_rands(count)
        batch = self.pre.get_rands(count)                # [n, count]
        self._masks = (batch if self._masks is None else
                       FpArray.concatenate([self._masks, batch], axis=1))
        self.mask_count += count
        return self.mask_count

    def deal_mix_preproc(self, epochs: int = 1) -> int:
        self.pre.generate_triples(epochs * self.rounds * self.k)
        self.pre.generate_one_minus_ones(epochs * self.rounds * self.k)
        self.mix_budget += epochs
        return self.mix_budget

    def counts(self):
        """(triples, bits, inputmasks) still unclaimed — the per-server
        preprocess_report payload."""
        return (self.mix_budget * self.rounds * self.k,
                self.mix_budget * self.rounds * self.k,
                self.mask_count)

    # -- online ------------------------------------------------------------
    def mask_share(self, server_id: int, idx: int) -> int:
        return FpArray(self._masks.limbs[:, server_id, idx]).to_int()

    def message_shares(self, pairs):
        """pairs: [(masked_input, mask_idx)] -> shares [n, K] of the
        messages: the public masked inputs minus the masks' shares."""
        mask_shares = self._masks.take([i for _, i in pairs], axis=1)
        masked = FpArray.from_ints([v for v, _ in pairs], device=self.device)
        return self.ctx.ShareArray(
            masked.broadcast_to((self.n, self.k)) - mask_shares, self.t)

    def mix_epoch(self, epoch: int, pairs) -> list:
        """pairs: [(masked_input, mask_idx)] — unmask inside MPC, mix,
        open. Computed once per epoch; idempotent across servers."""
        if epoch not in self._mix_results:
            msg_shares = self.message_shares(pairs)
            if self.mix == "butterfly":
                mixed = iterated_butterfly_network_jit(
                    self.ctx, msg_shares, self.k)
                opened = mixed.open()
                # host-convert ONE party's view (all agree)
                out = sorted(int(v) for v in FpArray(
                    opened.limbs[:, 0]).to_ints())
            else:
                b_powers = self.ctx.from_preproc(self.pre.get_powers(self.k))
                out = power_mix(self.ctx, msg_shares, b_powers)
            self._mix_results[epoch] = out
        return self._mix_results[epoch]


class AsynchromixServer:
    """One server's contract-facing driver (reference AsynchromixServer,
    asynchromix.py:144-320): reports preprocessing, serves authorized
    mask-share requests off-chain, initiates epochs, watches
    MixingEpochInitiated, runs the epoch MPC and proposes the output."""

    def __init__(self, myid: int, coord: AsynchromixCoordinator, account,
                 group: ServerGroupSim, mask_target: int | None = None,
                 mix_target: int = 2):
        self.myid, self.coord, self.account = myid, coord, account
        self.group = group
        self.mask_target = mask_target or 2 * group.k
        self.mix_target = mix_target
        self._tasks = []

    def start(self):
        for coro in (self._offline_loop(), self._initiate_loop(),
                     self._mixing_loop()):
            t = asyncio.ensure_future(coro)
            t.add_done_callback(print_exception_callback)
            self._tasks.append(t)
        return self

    def kill(self):
        for t in self._tasks:
            t.cancel()

    # off-chain share channel (reference: clients request shares over
    # https; servers check contract authorization, asynchromix.py:84-95)
    async def req_mask(self, client, idx: int) -> int:
        if not self.coord.client_authorized(client, idx):
            raise PermissionError(f"client {client} not authorized for {idx}")
        return self.group.mask_share(self.myid, idx)

    async def _offline_loop(self):
        """Maintain preprocessing buffers above target and report counts
        (reference _offline_inputmasks_loop / _offline_mixes_loop; the
        consensus buffer is the min over all servers' reports)."""
        while True:
            did = False
            if self.coord.inputmasks_available() < self.mask_target and \
                    self.group.mask_count - self.coord.preprocess_used[2] \
                    < self.mask_target:
                # group deal is shared; idempotence: only the first server
                # to notice tops the pool up this round
                self.group.deal_masks(self.mask_target)
                did = True
            if self.coord.mixes_available() < self.mix_target and \
                    self.group.mix_budget * self.coord.PER_MIX_TRIPLES - \
                    self.coord.preprocess_used[0] < \
                    self.mix_target * self.coord.PER_MIX_TRIPLES:
                self.group.deal_mix_preproc(self.mix_target)
                did = True
            # report own counts regardless (consensus needs ALL reports)
            rep = self.group.counts()
            if (self.coord.preprocess_reports.get(self.myid) != list(rep)
                    or did):
                self.coord.preprocess_report(rep, sender=self.account)
            await asyncio.sleep(POLL)

    async def _initiate_loop(self):
        """Trigger a mix once K inputs + preprocessing are ready
        (reference _mixing_initiate_loop)."""
        while True:
            if (self.coord.inputs_ready() >= self.coord.K
                    and self.coord.mixes_available() >= 1):
                try:
                    self.coord.initiate_mix(sender=self.account)
                except Revert:
                    pass          # another server won the race
            await asyncio.sleep(POLL)

    async def _mixing_loop(self):
        """Consume MixingEpochInitiated events; run the MPC; vote the
        output (reference _mixing_loop, asynchromix.py:305-320)."""
        epoch = 0
        while True:
            if self.coord.epochs_initiated <= epoch:
                await asyncio.sleep(POLL)
                continue
            K = self.coord.K
            pairs = [self.coord.input_queue(i)
                     for i in range(epoch * K, (epoch + 1) * K)]
            mixed = self.group.mix_epoch(epoch, pairs)
            output = ",".join(str(v) for v in mixed)
            try:
                self.coord.propose_output(epoch, output, sender=self.account)
            except Revert:
                pass
            epoch += 1


class AsynchromixClient:
    """Client flow (reference AsynchromixClient, asynchromix.py:55-130):
    wait for masks, reserve one on-chain, privately reconstruct it from
    the servers' shares, publish m + r."""

    def __init__(self, account, coord: AsynchromixCoordinator, servers):
        self.account, self.coord, self.servers = account, coord, servers
        self.poly = polynomials_over(GF(P))

    async def _get_inputmask(self, idx: int) -> int:
        shares = await asyncio.gather(*[
            s.req_mask(self.account, idx) for s in self.servers])
        t = self.coord.t
        pts = [(i + 1, s) for i, s in enumerate(shares)][:t + 1]
        return int(self.poly.interpolate_at(pts, 0))

    async def send_message(self, m: int) -> int:
        while self.coord.inputmasks_available() < 1:
            await asyncio.sleep(POLL)
        rcpt = self.coord.reserve_inputmask(sender=self.account)
        idx = rcpt.events[0].args["inputmask_idx"]
        mask = await self._get_inputmask(idx)
        self.coord.submit_message(idx, (m + mask) % P, sender=self.account)
        return idx


async def run_one_epoch(n=4, t=1, k=8, seed=7, mix="butterfly",
                        device=torch.device("cuda")):
    """One full event-driven epoch; returns (messages, mixed_output)."""
    rng = random.Random(seed)
    accounts = [f"server{i}" for i in range(n)]
    coord = AsynchromixCoordinator(accounts, t, k=k)
    group = ServerGroupSim(n, t, k, seed=seed, mix=mix, device=device)
    servers = [AsynchromixServer(i, coord, accounts[i], group).start()
               for i in range(n)]
    messages = [rng.randrange(P) for _ in range(k)]
    clients = [AsynchromixClient(f"client{j}", coord, servers)
               for j in range(k)]
    try:
        await asyncio.gather(*[c.send_message(m)
                               for c, m in zip(clients, messages)])
        while coord.outputs_ready < 1:          # watch for MixOutput
            await asyncio.sleep(POLL)
    finally:
        for s in servers:
            s.kill()
    ev = coord.get_events("MixOutput")[0]
    mixed = [int(v) for v in ev.args["output"].split(",")]
    return messages, mixed


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One event-driven AsynchroMix epoch on the port.")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--t", type=int, default=1)
    ap.add_argument("--k", type=int, default=8, help="messages per epoch")
    ap.add_argument("--mix", choices=("butterfly", "powers"),
                    default="butterfly")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    messages, mixed = asyncio.run(run_one_epoch(
        args.n, args.t, args.k, mix=args.mix, device=args.device))
    assert sorted(messages) == sorted(mixed), "mixing lost messages!"
    print(f"asynchromix: epoch of {len(messages)} messages mixed correctly "
          f"by the {args.mix} mix at n={args.n}, t={args.t} on "
          f"{args.device} (event-driven: InputMaskClaimed -> "
          "MessageSubmitted -> MixingEpochInitiated -> MixOutput)")


if __name__ == "__main__":
    main()
