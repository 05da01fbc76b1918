"""Host-side helpers: channel names, zenith angle, YAML configs."""
