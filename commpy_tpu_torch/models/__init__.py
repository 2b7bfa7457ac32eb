"""Batched link models and the device IDD loop."""
from .device_links import (DeviceLink, make_bch_awgn_link,
                           make_bestfirst_ldpc_mimo_link, make_conv_awgn_link,
                           make_dvbs2_concat_link,
                           make_idd_kbest_ldpc_mimo_link, make_isi_conv_link,
                           make_kbest_mimo_link, make_ldpc_rayleigh_link,
                           make_ofdm_mimo_conv_link, make_ofdm_qcldpc_link,
                           make_polar_awgn_link, make_qcldpc_awgn_link,
                           make_rrc_conv_awgn_link, make_rs_awgn_link,
                           make_turbo_awgn_link)
from .idd import idd_decoder_device
from .wifi80211_link import (WIFI_MCS_TABLE, wifi80211_device_link,
                             wifi80211n_ldpc_link)

__all__ = ["DeviceLink", "make_conv_awgn_link", "make_rrc_conv_awgn_link",
           "make_turbo_awgn_link", "make_qcldpc_awgn_link",
           "make_ldpc_rayleigh_link", "make_kbest_mimo_link",
           "make_bestfirst_ldpc_mimo_link", "make_ofdm_mimo_conv_link",
           "make_ofdm_qcldpc_link", "make_dvbs2_concat_link",
           "make_isi_conv_link", "make_bch_awgn_link", "make_rs_awgn_link",
           "make_polar_awgn_link", "make_idd_kbest_ldpc_mimo_link",
           "idd_decoder_device", "wifi80211_device_link",
           "wifi80211n_ldpc_link", "WIFI_MCS_TABLE"]
