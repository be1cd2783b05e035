"""Model layer of the port: ``GPModel`` facade, Vecchia GP, fitting."""
