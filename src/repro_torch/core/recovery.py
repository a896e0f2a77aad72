"""LOG.io rollback recovery (Algorithms 6-9) + replay mode (Algorithms 10-11).

Recovery of an operator OP (state "restarted"):
  1. recover output events: resend everything "undone" + unacknowledged
     (InSet null) in increasing event_id order (Alg 6 step 1 / Alg 7 step 1);
     replay operators regenerate instead of resending (Alg 10).
  2. recover pending write actions (Alg 8) — exactly-once via checkable
     writes.
  3. recover processing: restore global state + LOG.io context from STATE,
     re-process "undone"+acknowledged input events against ONLY their
     assigned Input Set (Alg 9 step 2), trigger generation as it fires.
  4. resume normal processing.

Replay mode (Sec. 5): a *replay operator* (deterministic + lineage on all
ports) does not log output payloads. On failure its outputs are regenerated
from their Input Sets (EVENT_LINEAGE gives output -> InSet). When a consumer
of a replay operator fails, it marks the inputs it needs as "replay"; the
engine restarts the replay predecessors in state "replay" and they
regenerate those outputs (recursively up chains of replay operators).

Transport interaction (repro_torch.core.transport): step 1's resends flow
through ordinary credit-gated ``put``s, so a recovering operator is
back-pressured like any sender (it blocks, abortably, while a receiver's
window is exhausted — deliveries and credit grants keep flowing
underneath).  The transport itself rewinds the per-channel windows on a
warm restart: the routed supervisor re-grants the fresh sender incarnation
``capacity - len(buffer)`` credits and rewinds the receiver's delivery
cursor; the socket transport rebuilds the sender-held buffer from the
resends themselves, so the window resets implicitly and a SIGKILL'd
receiver never strands a sender.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple

from repro_torch.core.events import DONE, REPLAY, UNDONE
from repro_torch.core.operator import OperatorRuntime


def recover_operator(rt: OperatorRuntime, *, is_source: bool = False,
                     source_driver=None,
                     replay_pred_ports: Set[str] = frozenset(),
                     include_done: bool = False):
    """Full recovery sequence for one restarted operator.

    replay_pred_ports: input ports whose senders are replay operators (their
    payloads are not in EVENT_DATA; regenerated events arrive via channels).

    include_done: the operator's group runs (or recently ran) in "epoch"
    recovery mode, so the restored snapshot may be up to ``state_interval``
    generate-transactions stale.  The ack-events scan then includes DONE
    rows: their global-state contributions replay through the
    ``global_updated`` guard (triggers and event state are NOT rebuilt for
    them — their Input Sets completed, regenerating would duplicate
    outputs).  Recovery ends by persisting a fresh snapshot so the next
    restart is re-bounded.
    """
    op = rt.op
    # Alg 9 step 1 / Alg 6 step 2: restore global state + context, advance SSNs
    rt.restore_state()

    # ---- recover output events --------------------------------------------
    if rt.replay_mode:
        _prepare_replay(rt)
    else:
        # one range scan per operator (single sqlite query / sequential
        # segment-image read), never per-event round trips
        rt.stats["recovery_scan_batches"] += 1
        for ev, status in rt.store.fetch_resend_events(op.id):
            rt._send(ev)
            rt.stats["recovered_resends"] += 1
    rt.crash_point(op.id, "recovery_post_resend")

    # ---- write actions (Alg 8) -------------------------------------------
    rt.recover_writes()

    # ---- source: resume its read action (Alg 6 steps 3-4) ----------------
    if is_source and source_driver is not None:
        source_driver.resume(rt)
        op.state = "running"
        return

    # ---- recover processing (Alg 9 step 2 / Alg 11) ----------------------
    replay_out = getattr(op, "_replay_pending", {})
    if rt.replay_mode:
        # rewind SSNs so regenerated events reuse their original ids
        for (port, eid) in replay_out:
            rt.ctx.ssn[port] = min(rt.ctx.ssn.get(port, eid), eid)
    op._awaiting_replay = set()
    op._replay_pred_ports = set(replay_pred_ports)
    mark_txn = rt.store.begin()
    marks = []
    # Alg 9 step 1 analogue for Input Set ids: a batched input transaction
    # durably assigns freshly minted ids without snapshotting state (the
    # counter only rides generate transactions), so after a crash between
    # the two the restored counter can trail ids already bound to logged
    # events.  Ride the ack-events scan below to advance past them — a
    # reissued id would silently merge two unrelated Input Sets and cross
    # their lineage.
    inset_prefix = op.id + ":"
    rt.stats["recovery_scan_batches"] += 1      # one ack-events range scan
    ack_rows = list(rt.store.fetch_ack_events(op.id,
                                              include_done=include_done))
    for _ev, inset_id, _status in ack_rows:
        if inset_id and inset_id.startswith(inset_prefix):
            suffix = inset_id[len(inset_prefix):]
            if suffix.isdigit() and int(suffix) > rt.ctx.inset_counter:
                rt.ctx.inset_counter = int(suffix)
    for ev, inset_id, status in ack_rows:
        rt.stats["recovered_inputs"] += 1
        port = ev.rec_port
        if status == DONE:
            # stale-snapshot catch-up only: the guard skips contributions
            # the snapshot already holds
            if ev.event_id > rt.ctx.global_updated.get(port, -1):
                op.update_global(ev)
                rt.ctx.global_updated[port] = ev.event_id
            continue
        if port in replay_pred_ports and not rt.replay_mode:
            # Alg 11 step 3: payload unavailable — mark "replay" and await
            # the regenerated event from the replay predecessor.
            marks.append(((ev.send_op, ev.send_port, ev.event_id),
                          REPLAY, "*", op.id, None))
            op._awaiting_replay.add((port, ev.event_id, inset_id))
            continue
        if ev.event_id > rt.ctx.global_updated.get(port, -1):
            op.update_global(ev)
            rt.ctx.global_updated[port] = ev.event_id
        # Alg 9 step 2.c: update ONLY the event state for this Input Set
        op.on_event(ev, recovery_inset=inset_id)
        for inset in op.triggers():
            rt.generate(inset, replay_events=replay_out or None)
    if marks:
        # one vectored status flip for the whole awaited-replay set
        mark_txn.set_status_many(marks)
        mark_txn.commit()
    op._replay_pending = {}
    if rt.replay_mode:
        # regeneration rewound the SSN counters to reuse original ids;
        # re-advance past everything logged before resuming (Alg 10 step 3
        # only applies to the replayed range)
        for port, last in rt.store.last_sent_ssn(op.id).items():
            if port in rt.ctx.ssn:
                rt.ctx.ssn[port] = max(rt.ctx.ssn[port], last + 1)
    if include_done:
        # the state just rebuilt is current — persist it so the next
        # restart replays from here instead of re-scanning the DONE backlog
        txn = rt.store.begin()
        txn.put_state(op.id, rt.new_state_id(), rt._state_blob(),
                      keep_history=rt.keep_state_history)
        txn.commit()
        rt._since_state = 0
    rt.crash_point(op.id, "recovery_post_processing")
    op.state = "running"


def _prepare_replay(rt: OperatorRuntime):
    """Algorithm 10: determine Input Sets to replay; mark inputs/outputs."""
    op = rt.op
    store = rt.store
    replay_out: Dict[Tuple[str, int], str] = {}
    insets: Set[str] = set()
    # outputs marked REPLAY by consumers + UNDONE ones sent after them.
    # Also on a plain restart: a mark lives until the consumer takes the
    # regenerated event, so one found here is awaited still, whatever
    # interrupted the replay that was to fill it. repro.core scans only in
    # state "replay" and strands the consumer (see
    # test_replay_mode_recovers_where_repro_core_does_not).
    marked = store.fetch_replay_outputs(op.id)
    min_per_port: Dict[str, int] = {}
    for eid, port, _status in marked:
        min_per_port[port] = min(min_per_port.get(port, eid), eid)
        replay_out[(port, eid)] = None
    for port, mn in min_per_port.items():
        for eid in store.undone_outputs_after(op.id, port, mn):
            replay_out[(port, eid)] = None
    # restarted (or replay): also regenerate own unacked undone outputs
    rt.stats["recovery_scan_batches"] += 1      # one resend range scan
    for ev, status in store.fetch_resend_events(op.id):
        replay_out[(ev.send_port, ev.event_id)] = None
    # map each output to its Input Set via EVENT_LINEAGE (the filtered
    # query op: indexed on backends with pushdown, same full scan otherwise)
    for (port, eid) in list(replay_out):
        ins = store.query_lineage_insets((op.id, port, eid))
        if ins:
            replay_out[(port, eid)] = ins[0]
            insets.add(ins[0])
        else:
            del replay_out[(port, eid)]     # no lineage -> nothing to do
    if not replay_out:
        op._replay_pending = {}
        return
    # Alg 10 step 4: atomically mark inputs of those Input Sets as "replay"
    txn = store.begin()
    for ins in insets:
        txn.set_inset_status(op.id, ins, REPLAY)
    # one vectored flip for the whole replay set (only still-undone
    # receiver rows flip — done consumers keep DONE)
    txn.set_status_many([((op.id, port, eid), REPLAY, "*", None, UNDONE)
                         for (port, eid) in replay_out])
    txn.put_state(op.id, rt.new_state_id(), rt._state_blob(),
                  keep_history=rt.keep_state_history)
    txn.commit()
    op._replay_pending = dict(replay_out)
