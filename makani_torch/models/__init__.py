"""Models of the port: common layers, networks, stepper and registry."""
