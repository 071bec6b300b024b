"""Learning-rate policies and optimizer update rules."""
