"""Dependency-free multi-sheet .xlsx writer.

The port's own copy of ``disentagled_multimodal_fusion_tpu/utils/xlsx.py``
(numpy only), unchanged but for this paragraph.

The reference exports its analysis tables as multi-sheet Excel workbooks
via pandas + openpyxl (reference run.py:340-343, run_synthetic.py:214-229,
run_luma.py:348-353). openpyxl is not in this image, so this module writes
the workbook directly: .xlsx is a ZIP of SpreadsheetML XML parts, and the
subset we need (one table per sheet, shared header row, numbers + inline
strings) is small enough to emit by hand.

Produces a minimal but fully valid OOXML package:
  [Content_Types].xml, _rels/.rels, xl/workbook.xml,
  xl/_rels/workbook.xml.rels, xl/styles.xml, xl/worksheets/sheetN.xml

Numbers are written as native numeric cells, everything else as inline
strings (no shared-string table — simpler, and these workbooks are small).
NaN/None become empty cells. Verified round-trip by
tests/test_xlsx.py (stdlib zipfile + ElementTree reader).
"""

from __future__ import annotations

import re
import zipfile
from pathlib import Path
from typing import Dict, Iterable, List
from xml.sax.saxutils import escape

import numpy as np

_NS = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
_REL_NS = 'xmlns="http://schemas.openxmlformats.org/package/2006/relationships"'

_INVALID_SHEET_CHARS = re.compile(r"[\[\]:*?/\\]")


def _sheet_name(name: str, used: set) -> str:
    """Excel sheet-name rules: <=31 chars, no []:*?/\\, unique, non-empty."""
    clean = _INVALID_SHEET_CHARS.sub("_", str(name))[:31] or "Sheet"
    base, i = clean, 1
    while clean in used:
        suffix = f"_{i}"
        clean = base[: 31 - len(suffix)] + suffix
        i += 1
    used.add(clean)
    return clean


def _col_letter(idx: int) -> str:
    """0-based column index -> A, B, ..., Z, AA, ..."""
    letters = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        letters = chr(ord("A") + rem) + letters
    return letters


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float, np.integer, np.floating)):
        if isinstance(value, (float, np.floating)) and not np.isfinite(value):
            return ""  # NaN/inf -> blank, matching pandas' na_rep=""
        return f'<c r="{ref}"><v>{repr(float(value)) if isinstance(value, (float, np.floating)) else int(value)}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def _rows_xml(header: Iterable, rows: Iterable[Iterable]) -> str:
    out: List[str] = []
    for r, row in enumerate([list(header)] + [list(x) for x in rows], start=1):
        cells = "".join(
            _cell_xml(f"{_col_letter(c)}{r}", v) for c, v in enumerate(row)
        )
        out.append(f'<row r="{r}">{cells}</row>')
    return "".join(out)


def _worksheet_xml(header, rows) -> str:
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f"<worksheet {_NS}><sheetData>{_rows_xml(header, rows)}</sheetData></worksheet>"
    )


_STYLES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    f"<styleSheet {_NS}>"
    '<fonts count="1"><font><sz val="11"/><name val="Calibri"/></font></fonts>'
    '<fills count="1"><fill><patternFill patternType="none"/></fill></fills>'
    '<borders count="1"><border/></borders>'
    '<cellStyleXfs count="1"><xf/></cellStyleXfs>'
    '<cellXfs count="1"><xf xfId="0"/></cellXfs>'
    "</styleSheet>"
)


def write_xlsx(path, sheets: Dict[str, "object"]) -> None:
    """Write ``{sheet_name: DataFrame-like}`` to ``path`` as a .xlsx.

    Accepts pandas DataFrames or any object with ``.columns`` and
    ``.itertuples(index=False)``.
    """
    path = Path(path)
    used: set = set()
    names = [_sheet_name(n, used) for n in sheets]
    frames = list(sheets.values())

    sheet_entries = "".join(
        f'<sheet name="{escape(n, {chr(34): "&quot;"})}" sheetId="{i+1}" r:id="rId{i+1}"/>'
        for i, n in enumerate(names)
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f"<workbook {_NS} "
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f"<sheets>{sheet_entries}</sheets></workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f"<Relationships {_REL_NS}>"
        + "".join(
            f'<Relationship Id="rId{i+1}" '
            'Type="http://schemas.openxmlformats.org/officeDocument/2006/'
            f'relationships/worksheet" Target="worksheets/sheet{i+1}.xml"/>'
            for i in range(len(names))
        )
        + f'<Relationship Id="rId{len(names)+1}" '
        'Type="http://schemas.openxmlformats.org/officeDocument/2006/'
        'relationships/styles" Target="styles.xml"/>'
        "</Relationships>"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType='
        '"application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/styles.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>'
        + "".join(
            f'<Override PartName="/xl/worksheets/sheet{i+1}.xml" ContentType='
            '"application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
            for i in range(len(names))
        )
        + "</Types>"
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f"<Relationships {_REL_NS}>"
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/'
        'officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>"
    )

    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        zf.writestr("xl/styles.xml", _STYLES)
        for i, df in enumerate(frames):
            zf.writestr(
                f"xl/worksheets/sheet{i+1}.xml",
                _worksheet_xml(list(df.columns), df.itertuples(index=False)),
            )


def read_xlsx(path) -> Dict[str, List[List[object]]]:
    """Tiny reader for tests/inspection: sheet name -> rows (header first).

    Handles only what ``write_xlsx`` emits (numeric + inline-string cells,
    dense rows) plus shared strings, so it can also sanity-read files
    written by openpyxl.
    """
    import xml.etree.ElementTree as ET

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
          "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships"}
    out: Dict[str, List[List[object]]] = {}
    with zipfile.ZipFile(path) as zf:
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        rel_map = {
            rel.get("Id"): rel.get("Target")
            for rel in rels.findall(
                "{http://schemas.openxmlformats.org/package/2006/relationships}Relationship"
            )
        }
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            sst = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            shared = ["".join(t.text or "" for t in si.iter(f"{{{ns['m']}}}t"))
                      for si in sst.findall("m:si", ns)]
        for sheet in wb.findall("m:sheets/m:sheet", ns):
            target = rel_map[sheet.get(f"{{{ns['r']}}}id")]
            # OPC: absolute part names resolve from the package root,
            # relative ones from the workbook's directory (xl/)
            part = target.lstrip("/") if target.startswith("/") else f"xl/{target}"
            ws = ET.fromstring(zf.read(part))
            rows = []
            for row in ws.findall("m:sheetData/m:row", ns):
                vals: List[object] = []
                for c in row.findall("m:c", ns):
                    # honor the cell reference: blank cells are omitted from
                    # the file, so position by column letter, not sequence
                    ref = c.get("r", "")
                    letters = "".join(ch for ch in ref if ch.isalpha())
                    if letters:
                        col = 0
                        for ch in letters:
                            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
                        col -= 1
                    else:
                        col = len(vals)
                    while len(vals) <= col:
                        vals.append(None)
                    t = c.get("t")
                    if t == "inlineStr":
                        vals[col] = "".join(
                            el.text or "" for el in c.iter(f"{{{ns['m']}}}t"))
                    elif t == "s":
                        vals[col] = shared[int(c.findtext("m:v", "", ns))]
                    elif t == "b":
                        vals[col] = bool(int(c.findtext("m:v", "0", ns)))
                    else:
                        v = c.findtext("m:v", None, ns)
                        vals[col] = None if v is None else float(v)
                rows.append(vals)
            out[sheet.get("name")] = rows
    return out
