"""Channel naming and grouping helpers (ref makani/utils/features.py:20-140).

Names auxiliary channels consistently between preprocessor and dataloader,
finds water/wind channels, and groups ERA5-style channel names into
(atmospheric pressure-level groups, surface, dynamic-aux, static-aux) for the
channel-grouped FCN3 encoders.
"""

from __future__ import annotations

import re
from collections import OrderedDict

__all__ = ["get_auxiliary_channels", "get_water_channels", "get_wind_channels", "get_channel_groups"]


def get_auxiliary_channels(
    add_zenith=False,
    add_grid=False,
    grid_type=None,
    grid_num_frequencies=0,
    add_orography=False,
    add_landmask=False,
    landmask_preprocessing="floor",
    add_soiltype=False,
    add_copernicus_emb=False,
    n_noise_chan=0,
    **kwargs,
):
    """Names of channels appended after the prognostic ones, in append order."""
    names = []
    if add_zenith:
        names.append("xzen")
    if n_noise_chan > 0:
        names += [f"xnoise{c}" for c in range(n_noise_chan)]
    if add_grid:
        if grid_type == "sinusoidal":
            for f in range(1, grid_num_frequencies + 1):
                names += [f"xsgrlat{f}", f"xsgrlon{f}"]
        else:
            names += ["xgrlat", "xgrlon"]
    if add_orography:
        names.append("xoro")
    if add_landmask:
        if landmask_preprocessing in ("floor", "round"):
            names += ["xlsml", "xlsms"]
        elif landmask_preprocessing == "raw":
            names += ["xlsm"]
    if add_soiltype:
        names += [f"xst{i}" for i in range(8)]
    if add_copernicus_emb:
        names += [f"xcop{i}" for i in range(8)]
    return names


def get_water_channels(channel_names):
    """Indices of humidity/water channels (q*, r*, tcwv)."""
    return [i for i, ch in enumerate(channel_names) if ch[0] in {"q", "r"} or ch == "tcwv"]


def get_wind_channels(channel_names):
    """Indices of paired (u, v) wind channels, interleaved u,v per level."""
    chans = []
    for i, ch in enumerate(channel_names):
        if ch.startswith("u") and ("v" + ch[1:]) in channel_names:
            chans += [i, channel_names.index("v" + ch[1:])]
    return chans


def get_channel_groups(channel_names, aux_channel_names=()):
    """Group channels into atmo (by pressure level), surface, dyn-aux, stat-aux."""
    atmo_groups: "OrderedDict[int, list]" = OrderedDict()
    surf_chans = []
    for idx, chn in enumerate(channel_names):
        if re.search("[a-z]{1,3}[0-9]{1,4}$", chn) is not None and chn != "d2":
            plvl = int(re.search("[0-9]{1,4}$", chn).group())
            atmo_groups.setdefault(plvl, []).append(idx)
        else:
            surf_chans.append(idx)

    n_atmo = None
    atmo_chans = []
    for plvl, idx in atmo_groups.items():
        if n_atmo is None:
            n_atmo = len(idx)
        elif n_atmo != len(idx):
            raise ValueError(
                f"expected all pressure-level groups to have {n_atmo} channels, got {len(idx)} at {plvl}"
            )
        atmo_chans += idx

    dyn_aux_chans, stat_aux_chans = [], []
    for idx, chn in enumerate(aux_channel_names):
        if chn in ("xoro", "xlsml", "xlsms"):
            stat_aux_chans.append(idx + len(channel_names))
        else:
            dyn_aux_chans.append(idx + len(channel_names))

    return atmo_chans, surf_chans, dyn_aux_chans, stat_aux_chans, atmo_groups.keys()
