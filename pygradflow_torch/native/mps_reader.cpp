// Fast MPS reader for large LP files.
//
// Native counterpart of the pure-Python parser in runners/mps.py (the
// reference binds the native `mpspy` reader, runners/mps_runner.py).  The
// hot path of MPS parsing is tokenization of millions of COLUMNS lines;
// this reader does a single pass with open-addressing string interning and
// emits COO triplets plus bound/rhs arrays through a flat C ABI consumed
// via ctypes (no pybind11 dependency).
//
// Build: see pygradflow_torch/native/__init__.py (g++ -O2 -shared -fPIC).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = HUGE_VAL;

struct MPSData {
  std::string name;

  std::vector<std::string> row_names;  // constraint rows only
  std::vector<char> row_types;         // 'E', 'L', 'G'
  std::string obj_row;

  std::vector<std::string> col_names;

  // COO entries of the constraint matrix
  std::vector<int64_t> entry_rows;
  std::vector<int64_t> entry_cols;
  std::vector<double> entry_vals;

  std::vector<int64_t> obj_cols;
  std::vector<double> obj_vals;

  std::vector<double> rhs;     // per row
  std::vector<uint8_t> has_range;
  std::vector<double> range;   // per row

  std::vector<double> var_lb;
  std::vector<double> var_ub;

  double obj_offset = 0.0;

  std::unordered_map<std::string, int64_t> row_index;
  std::unordered_map<std::string, int64_t> col_index;

  std::string error;
};

std::vector<std::string> tokenize(const char* line) {
  std::vector<std::string> out;
  const char* p = line;
  while (*p) {
    while (*p && isspace((unsigned char)*p)) p++;
    if (!*p) break;
    const char* start = p;
    while (*p && !isspace((unsigned char)*p)) p++;
    out.emplace_back(start, p - start);
  }
  return out;
}

int64_t ensure_col(MPSData& d, const std::string& name) {
  auto it = d.col_index.find(name);
  if (it != d.col_index.end()) return it->second;
  int64_t idx = (int64_t)d.col_names.size();
  d.col_index.emplace(name, idx);
  d.col_names.push_back(name);
  d.var_lb.push_back(0.0);
  d.var_ub.push_back(kInf);
  return idx;
}

enum Section { S_NONE, S_ROWS, S_COLUMNS, S_RHS, S_RANGES, S_BOUNDS, S_OTHER };

bool parse(MPSData& d, FILE* f) {
  char buf[65536];
  Section section = S_NONE;

  while (fgets(buf, sizeof(buf), f)) {
    // strip trailing newline
    size_t len = strlen(buf);
    while (len && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) buf[--len] = 0;
    if (!len) continue;
    if (buf[0] == '*') continue;

    if (!isspace((unsigned char)buf[0])) {
      auto toks = tokenize(buf);
      if (toks.empty()) continue;
      const std::string& head = toks[0];
      if (head == "NAME") {
        if (toks.size() > 1) d.name = toks[1];
        section = S_OTHER;
      } else if (head == "ROWS") {
        section = S_ROWS;
      } else if (head == "COLUMNS") {
        section = S_COLUMNS;
      } else if (head == "RHS") {
        section = S_RHS;
      } else if (head == "RANGES") {
        section = S_RANGES;
      } else if (head == "BOUNDS") {
        section = S_BOUNDS;
      } else if (head == "ENDATA") {
        break;
      } else {
        section = S_OTHER;
      }
      continue;
    }

    auto toks = tokenize(buf);
    if (toks.empty()) continue;

    switch (section) {
      case S_ROWS: {
        if (toks.size() < 2) break;
        char t = (char)toupper((unsigned char)toks[0][0]);
        if (t == 'N') {
          if (d.obj_row.empty()) d.obj_row = toks[1];
        } else if (t == 'E' || t == 'L' || t == 'G') {
          int64_t idx = (int64_t)d.row_names.size();
          d.row_index.emplace(toks[1], idx);
          d.row_names.push_back(toks[1]);
          d.row_types.push_back(t);
          d.rhs.push_back(0.0);
          d.has_range.push_back(0);
          d.range.push_back(0.0);
        }
        break;
      }
      case S_COLUMNS: {
        if (toks.size() >= 3 && toks[1] == "'MARKER'") break;  // integrality
        if (toks.size() < 3) break;
        int64_t ci = ensure_col(d, toks[0]);
        for (size_t i = 1; i + 1 < toks.size(); i += 2) {
          double v = atof(toks[i + 1].c_str());
          if (toks[i] == d.obj_row) {
            d.obj_cols.push_back(ci);
            d.obj_vals.push_back(v);
          } else {
            auto it = d.row_index.find(toks[i]);
            if (it != d.row_index.end()) {
              d.entry_rows.push_back(it->second);
              d.entry_cols.push_back(ci);
              d.entry_vals.push_back(v);
            }
          }
        }
        break;
      }
      case S_RHS: {
        for (size_t i = 1; i + 1 < toks.size(); i += 2) {
          double v = atof(toks[i + 1].c_str());
          if (toks[i] == d.obj_row) {
            d.obj_offset = -v;
          } else {
            auto it = d.row_index.find(toks[i]);
            if (it != d.row_index.end()) d.rhs[it->second] = v;
          }
        }
        break;
      }
      case S_RANGES: {
        for (size_t i = 1; i + 1 < toks.size(); i += 2) {
          auto it = d.row_index.find(toks[i]);
          if (it != d.row_index.end()) {
            d.has_range[it->second] = 1;
            d.range[it->second] = atof(toks[i + 1].c_str());
          }
        }
        break;
      }
      case S_BOUNDS: {
        if (toks.size() < 3) break;
        std::string btype = toks[0];
        for (auto& c : btype) c = (char)toupper((unsigned char)c);
        int64_t j = ensure_col(d, toks[2]);
        double v = toks.size() > 3 ? atof(toks[3].c_str()) : 0.0;
        if (btype == "UP") {
          d.var_ub[j] = v;
          if (v < 0 && d.var_lb[j] == 0.0) d.var_lb[j] = -kInf;
        } else if (btype == "LO") {
          d.var_lb[j] = v;
        } else if (btype == "FX") {
          d.var_lb[j] = d.var_ub[j] = v;
        } else if (btype == "FR") {
          d.var_lb[j] = -kInf;
          d.var_ub[j] = kInf;
        } else if (btype == "MI") {
          d.var_lb[j] = -kInf;
        } else if (btype == "PL") {
          d.var_ub[j] = kInf;
        } else if (btype == "BV") {
          d.var_lb[j] = 0.0;
          d.var_ub[j] = 1.0;
        } else if (btype == "UI") {
          d.var_ub[j] = v;
        } else if (btype == "LI") {
          d.var_lb[j] = v;
        }
        break;
      }
      default:
        break;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Opaque handle API consumed through ctypes.
void* mps_parse(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) return nullptr;
  auto* d = new MPSData();
  parse(*d, f);
  fclose(f);
  return d;
}

void mps_free(void* h) { delete (MPSData*)h; }

int64_t mps_num_rows(void* h) { return (int64_t)((MPSData*)h)->row_names.size(); }
int64_t mps_num_cols(void* h) { return (int64_t)((MPSData*)h)->col_names.size(); }
int64_t mps_num_entries(void* h) { return (int64_t)((MPSData*)h)->entry_vals.size(); }
int64_t mps_num_obj_entries(void* h) { return (int64_t)((MPSData*)h)->obj_vals.size(); }
double mps_obj_offset(void* h) { return ((MPSData*)h)->obj_offset; }

const char* mps_name(void* h) { return ((MPSData*)h)->name.c_str(); }

void mps_entries(void* h, int64_t* rows, int64_t* cols, double* vals) {
  auto* d = (MPSData*)h;
  memcpy(rows, d->entry_rows.data(), d->entry_rows.size() * sizeof(int64_t));
  memcpy(cols, d->entry_cols.data(), d->entry_cols.size() * sizeof(int64_t));
  memcpy(vals, d->entry_vals.data(), d->entry_vals.size() * sizeof(double));
}

void mps_obj(void* h, int64_t* cols, double* vals) {
  auto* d = (MPSData*)h;
  memcpy(cols, d->obj_cols.data(), d->obj_cols.size() * sizeof(int64_t));
  memcpy(vals, d->obj_vals.data(), d->obj_vals.size() * sizeof(double));
}

// cons_lb/cons_ub computed from row types + rhs + ranges (same semantics
// as runners/mps.py)
void mps_cons_bounds(void* h, double* lb, double* ub) {
  auto* d = (MPSData*)h;
  size_t m = d->row_names.size();
  for (size_t i = 0; i < m; i++) {
    char t = d->row_types[i];
    double b = d->rhs[i];
    double lo = -kInf, hi = kInf;
    if (t == 'E') {
      lo = hi = b;
    } else if (t == 'L') {
      hi = b;
    } else {  // 'G'
      lo = b;
    }
    if (d->has_range[i]) {
      double r = d->range[i];
      if (t == 'L') lo = hi - fabs(r);
      else if (t == 'G') hi = lo + fabs(r);
      else if (t == 'E') {
        if (r >= 0) hi = lo + r;
        else lo = hi + r;
      }
    }
    lb[i] = lo;
    ub[i] = hi;
  }
}

void mps_var_bounds(void* h, double* lb, double* ub) {
  auto* d = (MPSData*)h;
  memcpy(lb, d->var_lb.data(), d->var_lb.size() * sizeof(double));
  memcpy(ub, d->var_ub.data(), d->var_ub.size() * sizeof(double));
}

}  // extern "C"
