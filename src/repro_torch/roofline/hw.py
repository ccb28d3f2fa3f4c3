"""Hardware constants the port shares (copy of ``repro.roofline.hw``'s
``KV_LINK_GBPS``; the rest of the roofline package comes in slice 8)."""

# Inter-pool KV link bandwidth in GB/s: the one number every KV-movement
# model shares (disaggregated prefill->decode transfer, cluster prefix-tier
# installs). A modelling constant of the virtual clock, not a measurement.
KV_LINK_GBPS = 32.0
