"""Configurations of the port. ``paper_nets``: the paper's four networks
(§4), each with its ladder, full and reduced configs and input shapes."""
