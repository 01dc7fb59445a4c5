"""In-process EVM double of the Asynchromix coordinator contract.

Counterpart of ``apps/evm_double.py``, copied unchanged but for this text.
The reference coordinates mixing epochs through an Ethereum contract
(reference apps/asynchromix/asynchromix.sol) that its client/server loops
watch via web3 calls and event logs (asynchromix.py:55-130, :300-562).
web3 and solc are not dependencies of the package, so this module
provides a Python twin of `apps/contracts/AsynchromixCoordinator.sol` with
the SAME state machine, function surface, require conditions, and
events — transactions return a receipt carrying the emitted events, and
pollers can query the event log by name, exactly the two channels a chain
deployment offers. A surface parity test (tests/test_torch_asynchromix.py)
asserts every function and event here exists in the shipped .sol artifact.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Revert(Exception):
    """require() failure — the transaction leaves no state change.

    State mutations in this double are ordered so every require runs
    before the first write, mirroring the contract."""


def require(cond: bool, msg: str):
    if not cond:
        raise Revert(msg)


@dataclass
class Event:
    name: str
    args: dict
    block: int


@dataclass
class Receipt:
    block: int
    events: list = field(default_factory=list)


class AsynchromixCoordinator:
    """Twin of apps/contracts/AsynchromixCoordinator.sol."""

    def __init__(self, servers: list, t: int, k: int = 32):
        require(len(servers) > 3 * t, "need n > 3t")
        require(k > 0 and (k & (k - 1)) == 0, "K must be a power of two")
        self.n = len(servers)
        self.t = t
        self.K = k
        logk = k.bit_length() - 1
        self.PER_MIX_TRIPLES = (k // 2) * logk * logk
        self.PER_MIX_BITS = (k // 2) * logk * logk
        self.servers = list(servers)
        self.servermap = {s: i + 1 for i, s in enumerate(servers)}

        self.preprocess = [0, 0, 0]          # triples, bits, inputmasks
        self.preprocess_used = [0, 0, 0]
        self.preprocess_reports = {}         # server id -> [t, b, m]

        self.inputmasks_claimed = {}         # idx -> client address
        self._input_queue = []               # (masked_input, inputmask_idx)

        self.inputs_mixed = 0
        self.epochs_initiated = 0
        self.outputs_ready = 0
        self.output_hashes = []
        self.output_votes = []
        self.server_voted = {}               # id -> next votable epoch

        self._log: list[Event] = []
        self._block = 0

    # -- event plumbing (the web3 event-log channel) ----------------------
    def _tx(self) -> Receipt:
        self._block += 1
        return Receipt(self._block)

    def _emit(self, receipt: Receipt, name: str, **args):
        ev = Event(name, args, receipt.block)
        self._log.append(ev)
        receipt.events.append(ev)

    def get_events(self, name: str, start: int = 0) -> list:
        """All `name` events from log position `start` (poller channel)."""
        return [e for e in self._log[start:] if e.name == name]

    # -- views -------------------------------------------------------------
    def inputmasks_available(self) -> int:
        return self.preprocess[2] - self.preprocess_used[2]

    def mixes_available(self) -> int:
        return min(
            (self.preprocess[0] - self.preprocess_used[0])
            // self.PER_MIX_TRIPLES,
            (self.preprocess[1] - self.preprocess_used[1])
            // self.PER_MIX_BITS)

    def input_queue_length(self) -> int:
        return len(self._input_queue)

    def input_queue(self, idx: int):
        """(masked_input, inputmask_idx), like the public array getter."""
        return self._input_queue[idx]

    def inputs_ready(self) -> int:
        return len(self._input_queue) - self.inputs_mixed

    def client_authorized(self, client, idx: int) -> bool:
        return self.inputmasks_claimed.get(idx) == client

    # -- transactions --------------------------------------------------------
    def preprocess_report(self, rep, *, sender) -> Receipt:
        require(sender in self.servermap, "not a server")
        rcpt = self._tx()
        self.preprocess_reports[self.servermap[sender] - 1] = list(rep)
        mins = [
            min(self.preprocess_reports.get(i, [0, 0, 0])[j]
                for i in range(self.n))
            for j in range(3)]
        grew = any(m > p for m, p in zip(mins, self.preprocess))
        self.preprocess = mins
        if grew:
            self._emit(rcpt, "PreProcessUpdated")
        return rcpt

    def reserve_inputmask(self, *, sender) -> Receipt:
        require(self.preprocess[2] > self.preprocess_used[2],
                "no masks available")
        rcpt = self._tx()
        idx = self.preprocess_used[2]
        self.inputmasks_claimed[idx] = sender
        self.preprocess_used[2] += 1
        self._emit(rcpt, "InputMaskClaimed", client=sender, inputmask_idx=idx)
        return rcpt

    def submit_message(self, inputmask_idx: int, masked_input: int,
                       *, sender) -> Receipt:
        require(self.inputmasks_claimed.get(inputmask_idx) == sender,
                "mask not claimed by sender")
        rcpt = self._tx()
        self._input_queue.append((masked_input, inputmask_idx))
        self._emit(rcpt, "MessageSubmitted", idx=len(self._input_queue) - 1,
                   inputmask_idx=inputmask_idx, masked_input=masked_input)
        del self.inputmasks_claimed[inputmask_idx]   # single use
        return rcpt

    def initiate_mix(self, *, sender=None) -> Receipt:
        require(len(self._input_queue) >= self.inputs_mixed + self.K,
                "need K inputs")
        require(self.preprocess[0] >=
                self.preprocess_used[0] + self.PER_MIX_TRIPLES,
                "need triples")
        require(self.preprocess[1] >=
                self.preprocess_used[1] + self.PER_MIX_BITS, "need bits")
        rcpt = self._tx()
        self.preprocess_used[0] += self.PER_MIX_TRIPLES
        self.preprocess_used[1] += self.PER_MIX_BITS
        self.inputs_mixed += self.K
        self._emit(rcpt, "MixingEpochInitiated", epoch=self.epochs_initiated)
        self.epochs_initiated += 1
        self.output_hashes.append(None)
        self.output_votes.append(0)
        return rcpt

    def propose_output(self, epoch: int, output: str, *, sender) -> Receipt:
        require(epoch < self.epochs_initiated, "epoch not initiated")
        require(sender in self.servermap, "not a server")
        sid = self.servermap[sender] - 1
        require(epoch >= self.server_voted.get(sid, 0),
                "already voted this epoch")
        import hashlib
        h = hashlib.sha3_256(output.encode()).digest()
        if self.output_votes[epoch] > 0:
            require(h == self.output_hashes[epoch], "conflicting output")
        rcpt = self._tx()
        self.server_voted[sid] = epoch + 1
        if self.output_votes[epoch] == 0:
            self.output_hashes[epoch] = h
        self.output_votes[epoch] += 1
        if self.output_votes[epoch] == self.t + 1:
            self._emit(rcpt, "MixOutput", epoch=epoch, output=output)
            self.outputs_ready += 1
        return rcpt
