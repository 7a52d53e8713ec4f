"""Webhooks framework: adapt third-party JSON/form payloads into events
(a copy of the JAX package's ``api/webhooks.py``).

Parity: data/src/main/scala/.../data/webhooks/
{JsonConnector,FormConnector,ConnectorUtil}.scala and
data/.../api/Webhooks.scala:45-154 — per-site connectors registered under
``/webhooks/<site>.json`` (JSON) and ``/webhooks/<site>.form``
(form-encoded). Ships the same two example connectors the reference does:
SegmentIO (JSON; segmentio/SegmentIOConnector.scala) and MailChimp (form;
mailchimp/MailChimpConnector.scala).
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

from predictionio_tpu_torch.core.event import Event
from predictionio_tpu_torch.core.json_codec import event_from_json


class ConnectorError(ValueError):
    """Parity: ConnectorException."""


class JsonConnector(abc.ABC):
    """Converts a site's JSON payload to event JSON
    (JsonConnector.toEventJson, webhooks/JsonConnector.scala:24-32)."""

    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]: ...


class FormConnector(abc.ABC):
    """Converts a site's form payload to event JSON
    (FormConnector.toEventJson, webhooks/FormConnector.scala:25-33)."""

    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]: ...


def connector_to_event(connector, data: Mapping) -> Event:
    """Parity: ConnectorUtil.toEvent (webhooks/ConnectorUtil.scala:41-45)."""
    return event_from_json(connector.to_event_json(data))


class SegmentIOConnector(JsonConnector):
    """segment.io spec v2 payloads -> events.

    Parity: webhooks/segmentio/SegmentIOConnector.scala:25-270. Maps the
    six message types (identify/track/alias/page/screen/group) to events
    named after the type, entityType "user", entityId = userId (or
    anonymousId), eventTime = timestamp/sentAt.
    """

    _TYPES = ("identify", "track", "alias", "page", "screen", "group")

    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        if "version" not in data:
            raise ConnectorError("Failed to get segment.io API version.")
        msg_type = data.get("type")
        if msg_type not in self._TYPES:
            raise ConnectorError(
                f"Cannot convert unknown type {msg_type} to event JSON."
            )
        entity_id = data.get("userId") or data.get("anonymousId")
        if not entity_id:
            raise ConnectorError("there is no userId or anonymousId in the message")
        properties: dict[str, Any]
        if msg_type == "identify":
            properties = {"traits": data.get("traits", {})}
        elif msg_type == "track":
            properties = {
                "event": data.get("event"),
                "properties": data.get("properties", {}),
            }
        elif msg_type == "alias":
            properties = {"previousId": data.get("previousId")}
        elif msg_type in ("page", "screen"):
            properties = {
                "name": data.get("name"),
                "properties": data.get("properties", {}),
            }
        else:  # group
            properties = {
                "groupId": data.get("groupId"),
                "traits": data.get("traits", {}),
            }
        context = data.get("context")
        if context:
            properties["context"] = context
        out: dict[str, Any] = {
            "event": msg_type,
            "entityType": "user",
            "entityId": str(entity_id),
            "properties": {k: v for k, v in properties.items() if v is not None},
        }
        timestamp = data.get("timestamp") or data.get("sentAt")
        if timestamp:
            out["eventTime"] = timestamp
        return out


class MailChimpConnector(FormConnector):
    """MailChimp webhook form payloads -> events.

    Parity: webhooks/mailchimp/MailChimpConnector.scala:28-290. Supported
    types: subscribe, unsubscribe, profile, upemail, cleaned, campaign.
    entityType "user", entityId = the subscriber email/id.
    """

    _SUPPORTED = ("subscribe", "unsubscribe", "profile", "upemail", "cleaned", "campaign")

    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        msg_type = data.get("type")
        if msg_type not in self._SUPPORTED:
            raise ConnectorError(
                f"Cannot convert unknown type {msg_type} to event JSON."
            )
        def field(name: str) -> str | None:
            return data.get(f"data[{name}]")

        if msg_type == "cleaned":
            entity_id = field("email")
        elif msg_type == "upemail":
            entity_id = field("new_email")
        else:
            entity_id = field("email") or field("id")
        if not entity_id:
            raise ConnectorError(f"missing subscriber email/id in {msg_type} payload")
        properties = {
            k[len("data["):-1]: v for k, v in data.items()
            if k.startswith("data[") and k.endswith("]")
        }
        out: dict[str, Any] = {
            "event": msg_type,
            "entityType": "user",
            "entityId": entity_id,
            "properties": properties,
        }
        fired_at = data.get("fired_at")
        if fired_at:
            # MailChimp sends "2009-03-26 21:35:57" (UTC, no zone)
            out["eventTime"] = fired_at.replace(" ", "T")
        return out


#: Parity: WebhooksConnectors (webhooks/WebhooksConnectors.scala): the
#: registered site -> connector maps.
JSON_CONNECTORS: dict[str, JsonConnector] = {"segmentio": SegmentIOConnector()}
FORM_CONNECTORS: dict[str, FormConnector] = {"mailchimp": MailChimpConnector()}
