"""The program's entries the benchmark drives, one module a configuration's
"entry": make(config, traffic, device) returns the call the window times."""
