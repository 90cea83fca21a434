"""Transcript storage backends (the port's own copy of
``qrag_tpu.pipeline.storage``).

The reference reads podcast transcripts from S3, with the bucket name
resolved from AWS SSM (``mcp/server/tools/read_from_s3.py:86-120``):
it scans the bucket for ``*.json`` keys containing "transcript" with
>= 3 path segments, treats the first segment as the show name, and
loads each episode JSON.  This module keeps those *semantics* behind a
backend interface with two implementations:

  * `LocalTranscriptStore` — a directory tree
    ``<root>/<show>/<episode...>.json`` (usable offline; the default)
  * `S3TranscriptStore` — the reference's S3+SSM path, gated on boto3

Both return records shaped like the reference's
``{show_name, episode_id, file_path, data}``
(``read_from_s3.py:149-163``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Protocol


class TranscriptStore(Protocol):
    def list_shows(self) -> List[str]: ...

    def read_show(self, show_name: str) -> List[Dict[str, Any]]: ...


def _is_transcript_key(key: str) -> bool:
    """Key filter semantics of ``read_from_s3.py:104-120``."""
    return (
        key.endswith(".json")
        and "transcript" in key.lower()
        and len(key.split("/")) >= 3
    )


class LocalTranscriptStore:
    """Directory-backed store: ``<root>/<show>/<...>/<episode>.json``.

    Keys are relative paths; the same transcript-key filter applies, so
    files must live at least two levels below the show directory or
    contain "transcript" in their path to be picked up — mirroring the
    reference's S3 layout expectations.
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "QRAG_TRANSCRIPTS_DIR", "transcripts"
        )

    def _keys(self) -> List[str]:
        keys: List[str] = []
        if not os.path.isdir(self.root):
            return keys
        for dirpath, _dirs, files in os.walk(self.root):
            rel_dir = os.path.relpath(dirpath, self.root)
            for f in files:
                rel = f if rel_dir == "." else os.path.join(rel_dir, f)
                keys.append(rel.replace(os.sep, "/"))
        return sorted(keys)

    def list_shows(self) -> List[str]:
        shows = []
        for key in self._keys():
            if _is_transcript_key(key):
                show = key.split("/")[0]
                if show not in shows:
                    shows.append(show)
        return shows

    def read_show(self, show_name: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        prefix = show_name + "/"
        for key in self._keys():
            if not key.startswith(prefix) or not _is_transcript_key(key):
                continue
            path = os.path.join(self.root, key.replace("/", os.sep))
            try:
                with open(path) as f:
                    data = json.load(f)
            except Exception:
                continue  # per-file skip-on-error
            episode_id = os.path.splitext(key.split("/")[-1])[0]
            out.append(
                {
                    "show_name": show_name,
                    "episode_id": episode_id,
                    "file_path": key,
                    "data": data,
                }
            )
        return out


class S3TranscriptStore:
    """The reference's S3 path: bucket from SSM
    ``/app/app_storage_bucket``, paginated scan, per-key GET."""

    def __init__(
        self,
        bucket: Optional[str] = None,
        ssm_bucket_param: str = "/app/app_storage_bucket",
    ):
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "boto3 not installed; use LocalTranscriptStore"
            ) from e
        self._s3 = boto3.client("s3")
        if bucket is None:
            ssm = boto3.client("ssm")
            bucket = ssm.get_parameter(Name=ssm_bucket_param)["Parameter"][
                "Value"
            ]
        self.bucket = bucket

    def _keys(self) -> List[str]:
        keys: List[str] = []
        paginator = self._s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket):
            for obj in page.get("Contents", []):
                keys.append(obj["Key"])
        return keys

    def list_shows(self) -> List[str]:
        shows: List[str] = []
        for key in self._keys():
            if _is_transcript_key(key):
                show = key.split("/")[0]
                if show not in shows:
                    shows.append(show)
        return shows

    def read_show(self, show_name: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for key in self._keys():
            if not key.startswith(show_name + "/") or not _is_transcript_key(key):
                continue
            try:
                body = self._s3.get_object(Bucket=self.bucket, Key=key)[
                    "Body"
                ].read()
                data = json.loads(body)
            except Exception:
                continue
            episode_id = os.path.splitext(key.split("/")[-1])[0]
            out.append(
                {
                    "show_name": show_name,
                    "episode_id": episode_id,
                    "file_path": key,
                    "data": data,
                }
            )
        return out


def get_store(kind: str = "local", **kwargs) -> TranscriptStore:
    if kind == "local":
        return LocalTranscriptStore(**kwargs)
    if kind == "s3":
        return S3TranscriptStore(**kwargs)
    raise ValueError(f"unknown transcript store {kind!r}")
