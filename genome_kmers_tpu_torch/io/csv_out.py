"""Columnar CSV writer for the k-mer output paths.

The port's copy of ``genome_kmers_tpu/io/csv_out.py`` (host code only), so
that ``Kmers.to_csv`` writes the JAX package's bytes without importing it:
the pyarrow C writer (pandas fallback), the manually written unquoted
header (arrow always quotes header cells; the row-loop oracle does not),
the same duplicate-field handling.
"""

from __future__ import annotations

import numpy as np


def write_csv_columnar(cols, fields, names, kmer_len, var_kmer,
                       output_file_path) -> None:
    """Write ``cols`` (field -> numpy array, plus "chrom" as record IDS to
    be mapped through ``names``) to ``output_file_path`` in ``fields``
    order. ``var_kmer`` is the variable-width ``(data, offsets)`` byte pair
    when the kmer column is ragged (``kmer_len=None`` bulk decode), else
    None and the kmer column is a fixed-width ``S{kmer_len}`` array."""
    try:
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.csv as pacsv
    except ImportError:
        import pandas as pd

        if "chrom" in cols:
            cols["chrom"] = np.asarray(names, dtype=object)[cols["chrom"]]
        if "kmer" in cols:
            if var_kmer is not None:
                data, offsets = var_kmer
                b = data.tobytes()
                cols["kmer"] = np.asarray(
                    [
                        b[offsets[r] : offsets[r + 1]].decode("ascii")
                        for r in range(len(offsets) - 1)
                    ],
                    dtype=object,
                )
            else:
                cols["kmer"] = cols["kmer"].astype(f"U{kmer_len}")
        pd.DataFrame(cols).to_csv(
            output_file_path, index=False, columns=list(fields)
        )
        return
    arrow_cols = {}
    for field, v in cols.items():
        if field == "kmer":
            if var_kmer is not None:
                # zero-copy arrow string column straight from the
                # (offsets, data) decode buffers
                data, offsets = var_kmer
                n_rows = len(offsets) - 1
                if int(offsets[-1]) <= 2**31 - 1:
                    off32 = offsets.astype(np.int32)
                    arrow_cols[field] = pa.Array.from_buffers(
                        pa.string(), n_rows,
                        [None, pa.py_buffer(off32), pa.py_buffer(data)],
                    )
                else:
                    arrow_cols[field] = pa.Array.from_buffers(
                        pa.large_string(), n_rows,
                        [None, pa.py_buffer(offsets), pa.py_buffer(data)],
                    )
            else:
                arrow_cols[field] = pa.array(v).cast(pa.string())
        elif field == "chrom":
            arrow_cols[field] = pc.take(
                pa.array(list(names), type=pa.string()), pa.array(v)
            )
        elif field == "strand":
            arrow_cols[field] = pa.array(v.astype("U1"))
        else:
            arrow_cols[field] = pa.array(v)
    tbl = pa.table({f: arrow_cols[f] for f in dict.fromkeys(fields)})
    if list(dict.fromkeys(fields)) != list(fields):
        tbl = tbl.select(list(fields))  # duplicated field names
    with open(output_file_path, "wb") as f:
        # header written manually: arrow always quotes header cells,
        # the row-loop writer (and this path's contract) does not
        f.write((",".join(fields) + "\n").encode())
        pacsv.write_csv(
            tbl, f,
            pacsv.WriteOptions(include_header=False, quoting_style="none"),
        )
