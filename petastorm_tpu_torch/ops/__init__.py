"""Device-side ops of the port; each kernel sits beside its plain version."""
