"""SEG-Y 3200-byte textual header: decode/encode + processing provenance.

reference: pseudo_3D_interpolation/functions/header.py:250-477. The textual
header is 40 lines x 80 chars ("C01".."C40" prefixes), EBCDIC (cp037) or
ASCII. The provenance system maintains a centered
``***** PROCESSING WORKFLOW *****`` banner (default line 25) and appends
dated processing entries beneath it — appending to an existing line with the
same date prefix when it fits, else taking the next empty line.

A copy of ``pseudo_3d_interpolation_tpu/io/textual.py``, kept here:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import datetime

TEXT_SIZE = 3200
LINE_LENGTH = 80
N_LINES = 40
PREFIX_LEN = 3  # "C01"
WORKFLOW_HEADER = "***** PROCESSING WORKFLOW *****"


def decode_textual_header(raw: bytes) -> str:
    """3200 raw bytes -> 40 newline-joined 80-char lines (auto EBCDIC/ASCII)."""
    if len(raw) != TEXT_SIZE:
        raise ValueError(f"textual header must be {TEXT_SIZE} bytes, got {len(raw)}")
    # EBCDIC 'C' = 0xC3; ASCII 'C' = 0x43
    if raw[0] == 0xC3 or raw.count(b"\x40") > raw.count(b"\x20"):
        text = raw.decode("cp037", errors="replace")
    else:
        text = raw.decode("ascii", errors="replace")
    lines = [text[i * LINE_LENGTH : (i + 1) * LINE_LENGTH] for i in range(N_LINES)]
    return "\n".join(lines)


def encode_textual_header(text: str, ebcdic: bool = False) -> bytes:
    """Newline-joined lines (or free text) -> exactly 3200 bytes.

    Missing lines are created with their ``Cxx`` prefixes; each line is
    padded/truncated to 80 chars.
    """
    lines = text.split("\n") if text else []
    out = []
    for i in range(N_LINES):
        line = lines[i] if i < len(lines) else ""
        if not line.strip():
            line = f"C{i + 1:02d}"
        elif not line.startswith("C"):
            line = f"C{i + 1:02d} {line}"
        out.append(line[:LINE_LENGTH].ljust(LINE_LENGTH))
    joined = "".join(out)
    assert len(joined) == TEXT_SIZE
    return joined.encode("cp037" if ebcdic else "ascii", errors="replace")


def _split(text: str):
    lines = text.split("\n")
    if len(lines) != N_LINES:
        raise ValueError(f"expected {N_LINES} lines, got {len(lines)}")
    return [ln.ljust(LINE_LENGTH)[:LINE_LENGTH] for ln in lines]


def find_header_line(text: str, header: str = WORKFLOW_HEADER):
    """Index of the line containing ``header``, or None."""
    for i, line in enumerate(text.split("\n")):
        if header in line:
            return i
    return None


def ensure_workflow_header(text: str, line: int = 25) -> tuple[str, int]:
    """Ensure the centered workflow banner exists; return (text, line_idx)."""
    idx = find_header_line(text)
    if idx is not None:
        return text, idx
    lines = _split(text)
    if not _is_empty(lines[line - 1]):
        # reference set_header_line warns and overwrites (header.py:418-424)
        # — same semantics here, but prefer a nearby empty line first so
        # populated survey headers are not clobbered when space exists.
        # Relocating must leave at least one empty line BELOW the banner for
        # the entries themselves, else add_processing_entry hits
        # 'header is full' on a file the overwrite semantics could record.
        empties = [i for i in range(line - 1, len(lines))
                   if _is_empty(lines[i])]
        if len(empties) >= 2:
            line = empties[0] + 1
        else:
            import warnings

            warnings.warn(
                f"textual-header line {line} is in use and will be "
                "overwritten by the workflow banner", UserWarning,
                stacklevel=2)
    body = WORKFLOW_HEADER.center(LINE_LENGTH - PREFIX_LEN)
    lines[line - 1] = lines[line - 1][:PREFIX_LEN] + body
    return "\n".join(lines), line - 1


def _is_empty(line: str) -> bool:
    return len(line[PREFIX_LEN:].strip()) == 0


def add_processing_entry(
    text: str,
    info: str,
    prefix: str | None = "_TODAY_",
    header_line: int = 25,
) -> str:
    """Record a processing step in the textual header.

    ``prefix='_TODAY_'`` uses the current ISO date. If a line below the
    workflow banner already starts with the prefix and has room, the entry
    is appended there; otherwise the next empty line after the banner is
    used as ``"<prefix>: <info>"``.
    """
    if prefix in ("_TODAY_", "_DATE_"):
        prefix = datetime.date.today().strftime("%Y-%m-%d")

    text, idx_header = ensure_workflow_header(text, line=header_line)
    lines = _split(text)

    if prefix:
        for i in range(idx_header + 1, N_LINES):
            stripped = lines[i][PREFIX_LEN:].strip()
            if stripped.startswith(prefix):
                used = len(lines[i].rstrip())
                if used + 1 + len(info) <= LINE_LENGTH:  # exact fill is fine
                    lines[i] = (lines[i].rstrip() + " " + info).ljust(LINE_LENGTH)
                    return "\n".join(lines)

    entry = f" {prefix}: {info}" if prefix else f" {info}"
    for i in range(idx_header + 1, N_LINES):
        if _is_empty(lines[i]):
            lines[i] = (lines[i][:PREFIX_LEN] + entry)[:LINE_LENGTH].ljust(LINE_LENGTH)
            return "\n".join(lines)
    raise IndexError("SEG-Y textual header is full; cannot add more information.")


def get_processing_entries(text: str) -> list[str]:
    """All non-empty lines below the workflow banner (stripped)."""
    idx = find_header_line(text)
    if idx is None:
        return []
    out = []
    for line in text.split("\n")[idx + 1 :]:
        s = line[PREFIX_LEN:].strip()
        if s:
            out.append(s)
    return out
