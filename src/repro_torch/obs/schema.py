"""Event-schema registry for the session JSONL log.

Every event kind the co-simulation can emit is enumerated here with its
required and optional payload fields and their types. The replay test
(``tests/test_obs.py``) runs real ``browser-3g`` and
``browser-3g-lossy`` sessions and validates every event against this
table, so a payload rename, a dropped field, or a new unregistered kind
fails loudly instead of silently drifting (the PR 9 ``--event-log``
clobber is exactly the class of bug this catches).

``validate_event`` accepts either a :class:`SessionEvent` or a decoded
JSONL record (with top-level ``t_s``/``kind``/``seq``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

_NUM = (int, float)
_STR = (str,)
_INT = (int,)
_BOOL = (bool,)
_LIST = (list,)
_DICT = (dict,)


class SchemaError(ValueError):
    """An event failed validation against the registered schema."""


@dataclasses.dataclass(frozen=True)
class EventSchema:
    """Field table for one event kind. ``required``/``optional`` map
    field name to the tuple of accepted Python types (post-JSON, so
    tuples appear as lists). ``allow_extra`` admits unenumerated
    fields — only ``fault`` uses it, since injector kinds carry
    kind-specific detail."""

    kind: str
    required: Mapping[str, tuple]
    optional: Mapping[str, tuple] = dataclasses.field(default_factory=dict)
    allow_extra: bool = False

    def validate(self, data: Mapping[str, Any]) -> None:
        for field, types in self.required.items():
            if field not in data:
                raise SchemaError(
                    f"{self.kind}: missing required field {field!r} "
                    f"(payload keys: {sorted(data)})")
            self._check_type(field, data[field], types)
        for field, value in data.items():
            if field in self.required:
                continue
            if field in self.optional:
                self._check_type(field, value, self.optional[field])
            elif not self.allow_extra:
                raise SchemaError(
                    f"{self.kind}: unexpected field {field!r}")

    def _check_type(self, field: str, value: Any, types: tuple) -> None:
        # bool subclasses int; don't let a bool satisfy a numeric field
        if isinstance(value, bool) and bool not in types:
            raise SchemaError(
                f"{self.kind}.{field}: got bool, expected "
                f"{'/'.join(t.__name__ for t in types)}")
        if value is None or isinstance(value, types):
            return
        raise SchemaError(
            f"{self.kind}.{field}: got {type(value).__name__} "
            f"({value!r}), expected "
            f"{'/'.join(t.__name__ for t in types)}")


EVENT_SCHEMAS: dict[str, EventSchema] = {s.kind: s for s in [
    # -- byte-clock delivery events -------------------------------------
    EventSchema("chunk", {"bytes": _INT, "through": _INT}),
    EventSchema("header", {"bytes": _INT}),
    EventSchema("stage_complete", {"stage": _INT},
                {"through": _INT, "repair": _INT}),
    EventSchema("result_ready",
                {"stage": _INT, "process_start_s": _NUM}),
    # -- serving events -------------------------------------------------
    EventSchema("cold_start", {"stage": _INT},
                {"prompt_len": _INT, "n_slots": _INT, "clients": _INT}),
    EventSchema("decode_step", {"step": _INT, "stage": _INT}),
    EventSchema("upgrade", {"step": _INT, "stage": _INT}),
    EventSchema("accept_round",
                {"k": _INT, "accepted": (int, list), "rate": _NUM,
                 "stage": _INT},
                {"round": _INT, "emitted": _LIST,
                 "effective_bits": _DICT}),
    EventSchema("submit", {"rid": _INT}),
    EventSchema("admit", {"rid": _INT}),
    EventSchema("evict", {"rid": _INT}),
    EventSchema("pool_window",
                {"steps": _INT, "tokens": _INT, "active": _INT,
                 "stage": _INT}),
    # -- fault-channel events -------------------------------------------
    # payload field is "fault" (not "kind"): the JSONL export flattens
    # the payload next to the envelope, and a payload "kind" would
    # shadow the event kind (a real bug this schema caught)
    EventSchema("fault", {"fault": _STR}, allow_extra=True),
    EventSchema("retry",
                {"target": _STR, "attempt": _INT, "backoff_s": _NUM}),
    # unit-scoped events name the wire unit "unit", never "seq" — the
    # JSONL envelope owns "seq" (the event sequence number)
    EventSchema("quarantine", {"reason": _STR},
                {"unit": _INT, "target": _STR}),
    EventSchema("nack", {"unit": _INT, "rerequest_backoff_s": _NUM}),
    EventSchema("repair",
                {"unit": _INT, "attempt": _INT, "ok": _BOOL}),
    EventSchema("reconnect",
                {"reason": _STR, "cursor": _LIST, "attempt": _INT,
                 "backoff_s": _NUM}),
    EventSchema("resume", {"offset": _INT, "unit_seq": _INT}),
    EventSchema("transport_summary",
                {"injected": _DICT, "deliveries": _INT,
                 "quarantined": _INT, "repaired_units": _INT,
                 "duplicate_units": _INT, "reconnects": _INT,
                 "pending_nacks": _INT, "verified_units": _INT},
                {"framing_overhead": _DICT}),
]}

# top-level keys of a JSONL record that are envelope, not payload
_ENVELOPE = ("t_s", "kind", "seq")


def validate_event(event: Any) -> None:
    """Validate one event — a ``SessionEvent`` (anything with
    ``.kind``/``.data``) or a decoded JSONL record dict. Raises
    :class:`SchemaError` on unknown kinds, missing/unexpected fields,
    or type mismatches."""
    if isinstance(event, Mapping):
        if "kind" not in event or "t_s" not in event:
            raise SchemaError(
                f"record missing t_s/kind envelope: {sorted(event)}")
        if not isinstance(event["t_s"], _NUM) or isinstance(
                event["t_s"], bool):
            raise SchemaError(f"t_s must be numeric, got {event['t_s']!r}")
        if "seq" in event and not isinstance(event["seq"], int):
            raise SchemaError(f"seq must be int, got {event['seq']!r}")
        kind = event["kind"]
        data = {k: v for k, v in event.items() if k not in _ENVELOPE}
    else:
        kind = event.kind
        data = event.data
    schema = EVENT_SCHEMAS.get(kind)
    if schema is None:
        raise SchemaError(
            f"unknown event kind {kind!r} "
            f"(registered: {sorted(EVENT_SCHEMAS)})")
    schema.validate(data)


def validate_jsonl(text: str) -> int:
    """Validate every line of a session JSONL log; returns the number
    of events checked. Raises :class:`SchemaError` with the offending
    line number on the first failure."""
    n = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise SchemaError(f"line {lineno}: not JSON ({e})") from e
        try:
            validate_event(rec)
        except SchemaError as e:
            raise SchemaError(f"line {lineno}: {e}") from e
        n += 1
    return n
