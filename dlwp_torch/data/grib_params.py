"""NCEP GRIB2 parameter identification for CFS products (port of
``dlwp_tpu.data.grib_params``).

GRIB2 messages are identified authoritatively by the numeric triple
(discipline, parameterCategory, parameterNumber) from the public
NCEP/WMO GRIB2 code tables -- not by the decoder's shortName metadata,
which varies across eccodes versions and drops exotic parameters. The
reference resolves variables through a 97-row csv of these code-table
entries (``DLWP/data/cfsr_pgb_grib_table.csv``, matched at
``cfsr.py:455-459``); this module carries the same public code-table
identities as a typed registry.

``level_kind`` distinguishes how a parameter is vertically organized:
'pl' (isobaric levels -- the trainable fields), 'sfc' (single surface /
near-surface field), or a special GRIB level-type code as used in the CFS
pgb products.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GribParam:
    discipline: int
    category: int
    number: int
    level_kind: str  # 'pl' | 'sfc' | special level-type code


def _build() -> dict[str, GribParam]:
    table: dict[str, GribParam] = {}

    def add(level_kind, discipline, category, entries):
        for name, number in entries:
            table[name] = GribParam(discipline, category, number, level_kind)

    # --- Meteorological products (discipline 0) -------------------------
    # Temperature (category 0)
    add("pl", 0, 0, [("TMP", 0)])
    add("sfc", 0, 0, [
        ("TMP2", 0), ("TMAX", 4), ("TMIN", 5), ("DPT2", 6),
        ("LHTFL", 10), ("SHTFL", 11), ("SNOHF", 192),
    ])
    add("sigma", 0, 0, [("POT", 2)])
    # Moisture (category 1)
    add("pl", 0, 1, [("SPFH", 0), ("RH", 1), ("CLWMR", 22)])
    add("sfc", 0, 1, [
        ("SPFH2", 0), ("RH2", 1), ("PRATE", 7), ("APCP", 8),
        ("NCPCP", 9), ("ACPCP", 10), ("SNOD", 11), ("WEASD", 13),
        ("CRAIN", 192), ("CFRZR", 193), ("CICEP", 194), ("CSNOW", 195),
        ("CPRAT", 196), ("PEVPR", 200), ("SNOWC", 201), ("SBSNO", 212),
        ("QMAX", 219), ("QMIN", 220),
    ])
    add("108", 0, 1, [("PWAT", 3)])
    # Momentum (category 2)
    add("pl", 0, 2, [
        ("UGRD", 2), ("VGRD", 3), ("STRM", 4), ("VPOT", 5),
        ("VVEL", 8), ("ABSV", 10),
    ])
    add("sfc", 0, 2, [
        ("U10", 2), ("V10", 3), ("UFLX", 17), ("VFLX", 18),
        ("USTM", 194), ("VSTM", 195), ("FRICV", 197),
    ])
    add("7", 0, 2, [("VWSH", 192)])
    # Mass (category 3)
    add("pl", 0, 3, [("HGT", 5), ("GPA", 9), ("5WAVH", 193), ("5WAVA", 197)])
    add("sfc", 0, 3, [
        ("PRES", 0), ("PRMSL", 1), ("U-GWD", 194), ("V-GWD", 195),
        ("HPBL", 196),
    ])
    # Short-wave radiation (category 4)
    add("sfc", 0, 4, [
        ("DSWRF", 192), ("USWRF", 193), ("DUVB", 194), ("CDUVB", 195),
        ("CSDSF", 196), ("SWHR", 197), ("CSUSF", 198),
    ])
    # Long-wave radiation (category 5)
    add("sfc", 0, 5, [
        ("DLWRF", 192), ("ULWRF", 193), ("LWHR", 194), ("CSULF", 195),
        ("CSDLF", 196),
    ])
    # Cloud (category 6)
    add("200", 0, 6, [("TCDC", 1), ("CWAT", 6), ("CWORK", 193)])
    # Thermodynamic stability (category 7)
    add("108", 0, 7, [("PLI", 0), ("CAPE", 6), ("CIN", 7)])
    add("sfc", 0, 7, [("HLCY", 8), ("LFTX", 192), ("4LFTX", 193)])
    # Trace gases / physical properties
    add("200", 0, 14, [("TOZNE", 0)])
    add("sfc", 0, 19, [("ALBDO", 1)])

    # --- Hydrological products (discipline 1) ---------------------------
    add("sfc", 1, 0, [("SSRUN", 193)])

    # --- Land-surface products (discipline 2) ---------------------------
    add("sfc", 2, 0, [
        ("LAND", 0), ("SFCR", 1), ("SOILM", 3), ("VEG", 4), ("WATR", 5),
        ("SOILW", 192), ("GFLUX", 193), ("SFEXC", 195), ("CNWAT", 196),
        ("VGTYP", 198), ("AKHS", 208), ("AKMS", 209), ("VEGT", 210),
    ])
    add("sfc", 2, 3, [
        ("SOTYP", 0), ("SOILL", 192), ("SLTYP", 194), ("EVBS", 198),
    ])

    # --- Oceanographic products (discipline 10) -------------------------
    add("sfc", 10, 2, [("SEAI", 0)])

    return table


GRIB2_PARAMS: dict[str, GribParam] = _build()

# Reference-table spellings with spaces/dashes normalize to registry keys
# (e.g. 'U GRD' -> 'UGRD', 'R H' -> 'RH', 'T MAX' -> 'TMAX').
_SPELLINGS = {
    "U GRD": "UGRD", "V GRD": "VGRD", "V VEL": "VVEL", "ABS V": "ABSV",
    "SPF H": "SPFH", "SPF H2": "SPFH2", "R H": "RH", "R H2": "RH2",
    "P WAT": "PWAT", "T MAX": "TMAX", "T MIN": "TMIN", "V POT": "VPOT",
    "U FLX": "UFLX", "V FLX": "VFLX", "VW SH": "VWSH", "GP A": "GPA",
    "T CDC": "TCDC", "C WAT": "CWAT", "LFT X": "LFTX", "SNO D": "SNOD",
    "A PCP": "APCP", "SFC R": "SFCR", "SOIL M": "SOILM",
    # eccodes/pygrib shortNames for the default CFS pressure-level set
    "GH": "HGT", "T": "TMP", "U": "UGRD", "V": "VGRD", "W": "VVEL",
    "Q": "SPFH", "R": "RH",
}


def lookup(variable: str) -> GribParam | None:
    """Resolve a variable name (any common spelling) to its GRIB2 codes."""
    v = variable.upper()
    v = _SPELLINGS.get(v, v)
    return GRIB2_PARAMS.get(v.replace(" ", ""))
