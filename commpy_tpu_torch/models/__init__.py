"""Batched link models."""
from .device_links import (DeviceLink, make_bestfirst_ldpc_mimo_link,
                           make_conv_awgn_link, make_kbest_mimo_link,
                           make_ldpc_rayleigh_link, make_ofdm_mimo_conv_link,
                           make_ofdm_qcldpc_link, make_qcldpc_awgn_link,
                           make_turbo_awgn_link)
from .wifi80211_link import (WIFI_MCS_TABLE, wifi80211_device_link,
                             wifi80211n_ldpc_link)

__all__ = ["DeviceLink", "make_conv_awgn_link", "make_turbo_awgn_link",
           "make_qcldpc_awgn_link", "make_ldpc_rayleigh_link",
           "make_kbest_mimo_link", "make_bestfirst_ldpc_mimo_link",
           "make_ofdm_mimo_conv_link", "make_ofdm_qcldpc_link",
           "wifi80211_device_link", "wifi80211n_ldpc_link", "WIFI_MCS_TABLE"]
