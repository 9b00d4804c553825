"""Communication layer of the port: types, callsite tags, topology, engine."""
