// Host helpers of lidp_tpu_torch in C++ (the port's own copy of
// lidp_tpu/native/lidp_native.cpp): the paths on the host that grow with
// the atom count and that the reference runs in C++ (read_data.cpp,
// special.cpp, random_park.cpp, dump_custom.cpp).
//
//   parse_atoms        the rows of a data file's Atoms section
//   build_special_lists  the 1-2 / 1-3 / 1-4 lists of a bond graph
//   velocity_stream    the sequential Park-Miller stream of velocity create
//   format_dump_rows   the text rows of a dump frame ("%d" / "%g")
//
// A plain C interface, loaded with ctypes by lidp_tpu_torch/native.  Each
// function gives the bytes or values of its Python counterpart
// (io/data_reader.py, topology.py, rng.py, io/dump.py), which the tests
// hold it to bit for bit.
//
// Build: c++ -O2 -shared -fPIC lidp_native.cpp -o liblidp_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// A token ends at a space, a line's end, a comment or the buffer's end.
bool token_end(const char* p, const char* end) {
    return p >= end || is_space(*p) || *p == '\n' || *p == '#';
}

bool read_long(const char*& p, const char* end, long* out) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end || *p == '\n' || *p == '#') return false;
    char* next;
    *out = strtol(p, &next, 10);
    if (next == p || !token_end(next, end)) return false;
    p = next;
    return true;
}

bool read_double(const char*& p, const char* end, double* out) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end || *p == '\n' || *p == '#') return false;
    char* next;
    *out = strtod(p, &next);
    if (next == p || !token_end(next, end)) return false;
    p = next;
    return true;
}

}  // namespace

extern "C" {

// ------------------------------------------------------------- Atoms rows
// The rows `id [mol] type [q] x y z [ix iy iz]` of an Atoms section
// (atom_style full: mol and q; atomic: neither; charge: q; bond, angle
// and molecular: mol), from the line after the section's title.  Blank
// lines and comments are skipped; parsing stops after natoms rows, and
// *nlines gets the lines consumed.  Values go to index id-1.  Returns the
// rows parsed, or -1 for an id outside 1..natoms, -2 for a malformed
// row.  The file must hold the section NUL-free; `len` bounds it.
long parse_atoms(const char* buf, long len, long natoms, int has_mol,
                 int has_q, double* x, double* q, int32_t* type,
                 int32_t* mol, int32_t* image, long* nlines) {
    const char* p = buf;
    const char* end = buf + len;
    long count = 0, lines = 0;
    while (count < natoms && p < end) {
        const char* s = p;
        while (s < end && is_space(*s)) ++s;
        if (s >= end) break;
        if (*s == '\n' || *s == '#') {   // blank or comment line
            while (s < end && *s != '\n') ++s;
            p = (s < end) ? s + 1 : s;
            ++lines;
            continue;
        }
        p = s;
        long id, m = 0, t, ix = 0, iy = 0, iz = 0;
        double qq = 0.0, xx, yy, zz;
        if (!read_long(p, end, &id)) return -2;
        if (has_mol && !read_long(p, end, &m)) return -2;
        if (!read_long(p, end, &t)) return -2;
        if (has_q && !read_double(p, end, &qq)) return -2;
        if (!read_double(p, end, &xx) || !read_double(p, end, &yy)
            || !read_double(p, end, &zz))
            return -2;
        const char* r = p;
        while (r < end && is_space(*r)) ++r;
        if (r < end && *r != '\n' && *r != '#') {
            if (!read_long(p, end, &ix) || !read_long(p, end, &iy)
                || !read_long(p, end, &iz))
                return -2;
        }
        while (p < end && *p != '\n') ++p;   // the rest: a comment
        if (p < end) ++p;
        ++lines;
        if (id < 1 || id > natoms) return -1;
        long k = id - 1;
        if (has_mol) mol[k] = (int32_t)m;
        type[k] = (int32_t)t;
        if (has_q) q[k] = qq;
        x[3 * k] = xx;
        x[3 * k + 1] = yy;
        x[3 * k + 2] = zz;
        image[3 * k] = (int32_t)ix;
        image[3 * k + 1] = (int32_t)iy;
        image[3 * k + 2] = (int32_t)iz;
        ++count;
    }
    *nlines = lines;
    return count;
}

// ------------------------------------------------------------ dump rows
// nrows x ncols values as dump text rows ("%lld" for the columns is_int
// marks, "%g" for the others, a space between, a newline after each).
// Returns the bytes written, or -1 when cap is too small.
long format_dump_rows(long nrows, int ncols, const double* vals,
                      const uint8_t* is_int, char* out, long cap) {
    long w = 0;
    char buf[64];
    for (long r = 0; r < nrows; ++r) {
        for (int c = 0; c < ncols; ++c) {
            double v = vals[r * ncols + c];
            int len = is_int[c]
                ? snprintf(buf, sizeof(buf), "%lld", (long long)v)
                : snprintf(buf, sizeof(buf), "%g", v);
            if (w + len + 1 > cap) return -1;
            memcpy(out + w, buf, len);
            w += len;
            out[w++] = (c == ncols - 1) ? '\n' : ' ';
        }
    }
    return w;
}

// ---------------------------------------------------------- special lists
// bonds: nbonds pairs of 1-based atom ids.  idx_out (natoms*scap int32,
// filled with natoms by the caller) and lvl_out (natoms*scap int8, zeros)
// get each atom's 1-2, 1-3 and 1-4 partners, the closer relation first
// and sorted within a level.  Returns the largest count (rows longer than
// scap are left unwritten: the caller retries with a wider scap), or -2
// for an id out of range.
int build_special_lists(int natoms, long nbonds, const int64_t* bonds,
                        int scap, int32_t* idx_out, int8_t* lvl_out) {
    std::vector<std::vector<int>> adj(natoms);
    for (long b = 0; b < nbonds; ++b) {
        long i = (long)bonds[2 * b] - 1;
        long j = (long)bonds[2 * b + 1] - 1;
        if (i < 0 || j < 0 || i >= natoms || j >= natoms) return -2;
        adj[i].push_back((int)j);
        adj[j].push_back((int)i);
    }
    std::vector<int8_t> mark(natoms, 0);
    std::vector<int> touched, grp;
    int maxs = 0;
    for (int i = 0; i < natoms; ++i) {
        touched.clear();
        mark[i] = 4;   // itself
        touched.push_back(i);
        for (int j : adj[i])
            if (!mark[j]) { mark[j] = 1; touched.push_back(j); }
        size_t n12 = touched.size();
        for (size_t t = 1; t < n12; ++t)
            for (int k : adj[touched[t]])
                if (!mark[k]) { mark[k] = 2; touched.push_back(k); }
        size_t n13 = touched.size();
        for (size_t t = n12; t < n13; ++t)
            for (int k : adj[touched[t]])
                if (!mark[k]) { mark[k] = 3; touched.push_back(k); }
        int cnt = (int)touched.size() - 1;
        maxs = std::max(maxs, cnt);
        if (cnt <= scap) {
            int32_t* row = idx_out + (int64_t)i * scap;
            int8_t* lrow = lvl_out + (int64_t)i * scap;
            int k = 0;
            for (int8_t level = 1; level <= 3; ++level) {
                grp.clear();
                for (size_t t = 1; t < touched.size(); ++t)
                    if (mark[touched[t]] == level) grp.push_back(touched[t]);
                std::sort(grp.begin(), grp.end());
                for (int j : grp) { row[k] = j; lrow[k] = level; ++k; }
            }
        }
        for (int t : touched) mark[t] = 0;
    }
    return maxs;
}

// ----------------------------------------------- the velocity stream
// velocity create ... loop all (velocity.cpp:280-305): one RanPark stream
// over the atoms in order, three draws an atom; dist 0 uniform (draw -
// 0.5), 1 gaussian (Box-Muller with the second value saved).  out gets
// natoms*3 raw draws.
void velocity_stream(int seed, long natoms, int dist, double* out) {
    const int64_t IA = 16807, IM = 2147483647, IQ = 127773, IR = 2836;
    // the reference multiplies by the reciprocal (random_park.cpp:47); a
    // division differs in the last bit
    const double AM = 1.0 / 2147483647.0;
    int64_t state = seed;
    int save = 0;
    double second = 0.0;
    auto uniform = [&]() {
        int64_t k = state / IQ;
        state = IA * (state - k * IQ) - IR * k;
        if (state < 0) state += IM;
        return AM * (double)state;
    };
    auto gaussian = [&]() {
        if (save) { save = 0; return second; }
        double v1, v2, rsq;
        do {
            v1 = 2.0 * uniform() - 1.0;
            v2 = 2.0 * uniform() - 1.0;
            rsq = v1 * v1 + v2 * v2;
        } while (rsq >= 1.0 || rsq == 0.0);
        double fac = sqrt(-2.0 * log(rsq) / rsq);
        second = v1 * fac;
        save = 1;
        return v2 * fac;
    };
    for (long i = 0; i < 3 * natoms; ++i)
        out[i] = dist == 0 ? uniform() - 0.5 : gaussian();
}

}  // extern "C"
